// Fused Lloyd step (assign + update) for stage-1 k-means, batched over
// restarts, and its assign-only sibling, for Hopper (sm_90a).
//
// lloyd_step replaces the Pallas TPU kernel repro/kernels/kmeans.py::
// lloyd_step (body _lloyd_kernel).  Inputs: x (N, F) float32 or bfloat16,
// shared by all restarts; c (R, K, F) float32.  Outputs: labels int32
// (R, N), the min distance float32 (R, N), sums float32 (R, K, F) =
// onehot^T x and counts float32 (R, K).
//
// kmeans_assign replaces repro/kernels/kmeans.py::kmeans_assign (body
// _assign_kernel): labels int32 (N,) and min distances float32 (N,) of x
// (N, F) against one c (K, F).  It is the assign phase of lloyd_partial
// alone (UPDATE = false, R = 1): the same decomposition, the same first
// index on ties, no update and no reduce.  Bound on an H100: reading x
// (N*F bytes) against 2*N*K*F FMA-flops; at stage 1's K = 10 both are
// small, so launch latency sets its time at the main path's N = 100.
//
// What bounds it on an H100: one pass costs 2*N*K*F*R FMA-flops and must
// read x once (N*F*4 bytes).  At the fleet shape (N=100k, F=256, K=10,
// R=4) both give about 31 us on a 700 W H100 SXM, so neither dominates;
// at the main-path shape (N=100) launch latency does.
//
// Design (right and simple first):
//  * lloyd_partial: each block walks row tiles of TN=128 rows (tile b,
//    b+gridDim, ...).  One thread owns one row.  The tile streams through
//    shared memory in F-chunks of FC=32 (coalesced loads, any F); the
//    centroid chunk of G=40 (restart, centroid) pairs sits beside it and
//    is read as float4 broadcasts.  Each thread keeps its G running dot
//    products in registers, so one pass over the tile serves all of
//    stage 1 (R=4 restarts x K=10 clusters).  A larger R*K takes several
//    passes; pairs past R*K read as zero centroids and are ignored (a
//    wider fixed G would spend that idle work on stage 1 itself).
//    Distances use the reference's decomposition ||x||^2 - 2 x.c +
//    ||c||^2 in plain fp32 FMA on the CUDA cores (no TF32, no wgmma), and
//    the argmin keeps the first index on ties, so labels agree with the
//    plain version off near-ties.  Rows past N are masked in the kernel
//    (no padding copy).
//  * Every thread issues all of its loads of a chunk (x and centroids)
//    into registers before its first shared-memory store, so a chunk costs
//    one memory latency rather than one per element.
//  * The update uses no float atomics.  A block first assigns all of its
//    tiles, then for each F-chunk re-streams them and bins each row into a
//    shared (R, K, FC) accumulator (each thread owns one (restart,
//    feature) column, so there are no races; the labels come back from
//    global memory, read by the thread that wrote them).  The accumulator
//    is stored once per chunk into the block's slice of a (blocks, R, K,
//    F) scratch buffer, and counts are summed in registers.
//  * lloyd_reduce sums the slices over blocks in a fixed order, so sums
//    and counts are identical from run to run.  The wrapper caps the grid
//    at 4 blocks per SM, which bounds the scratch traffic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TN = 128;        // rows per tile = threads per block
constexpr int FC = 32;         // feature chunk
constexpr int XS = FC + 1;     // padded row stride of the x tile (no bank conflicts)
constexpr int G = 40;          // (restart, centroid) pairs per pass
constexpr int MAXR = 4;        // restarts per call (stage 1 runs 4)
constexpr int MAXK = 128;      // centroids per restart

template <bool BF16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

// Stage the (TN, FC) chunk of tile rows [row0, row0 + TN) x [f0, f0 + FC)
// into shared memory; rows >= N and features >= F read as 0.  Each thread
// loads its FC elements (lane = feature, so a warp reads 128 contiguous
// bytes of a row) into registers before its first store, so the chunk
// costs one memory latency, not FC of them in a row.
template <bool BF16>
__device__ __forceinline__ void load_tile(const void* x, float* xs, int row0,
                                          int f0, int N, int F) {
  static_assert(TN % FC == 0, "a warp must cover whole chunk rows");
  const int ff = threadIdx.x % FC, gf = f0 + ff;
  float v[FC];
#pragma unroll
  for (int j = 0; j < FC; ++j) {
    const int gr = row0 + j * (TN / FC) + threadIdx.x / FC;
    v[j] = (gr < N && gf < F) ? load_x<BF16>(x, (size_t)gr * F + gf) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < FC; ++j)
    xs[(j * (TN / FC) + threadIdx.x / FC) * XS + ff] = v[j];
}

// Stage the (G, FC) chunk of (restart, centroid) pairs [g0, g0 + G) x
// [f0, f0 + FC) of c into shared memory the same way; pairs >= RK and
// features >= F read as 0.
__device__ __forceinline__ void load_centroids(const float* c, float* cs,
                                               int g0, int f0, int RK,
                                               int F) {
  static_assert((G * FC) % TN == 0, "G * FC must be a multiple of TN");
  const int ff = threadIdx.x % FC, gf = f0 + ff;
  float v[G * FC / TN];
#pragma unroll
  for (int j = 0; j < G * FC / TN; ++j) {
    const int gp = g0 + j * (TN / FC) + threadIdx.x / FC;
    v[j] = (gp < RK && gf < F) ? c[(size_t)gp * F + gf] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < G * FC / TN; ++j)
    cs[(j * (TN / FC) + threadIdx.x / FC) * FC + ff] = v[j];
}

template <bool BF16, bool UPDATE>
__global__ void __launch_bounds__(TN)
lloyd_partial(const void* __restrict__ x, const float* __restrict__ c,
              int N, int F, int K, int R, int* __restrict__ labels,
              float* __restrict__ dist, float* __restrict__ psums,
              float* __restrict__ pcounts) {
  extern __shared__ __align__(16) float smem[];
  const int RK = R * K;
  float* xs = smem;                                   // TN * XS
  float* cs = xs + TN * XS;                           // max(G, RK) * FC
  float* sacc = cs;                                   // RK * FC (update phase)
  float* cn = cs + (G > RK ? G : RK) * FC;            // RK   ||c||^2
  float* best_d = cn + RK;                            // R * TN
  int* labs = reinterpret_cast<int*>(best_d + R * TN);  // R * TN
  const int tid = threadIdx.x;
  const int ntiles = (N + TN - 1) / TN;

  // counts of the (restart, centroid) pairs this thread owns, summed over
  // the block's tiles in registers
  constexpr int CNT = MAXR * MAXK / TN;
  float cnt[CNT];
#pragma unroll
  for (int j = 0; j < CNT; ++j) cnt[j] = 0.f;

  // ---- assign: labels and distances of every tile of this block ----
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TN;
    const int row = row0 + tid;
    const bool valid = row < N;
    for (int r = 0; r < R; ++r) {
      best_d[r * TN + tid] = INFINITY;
      labs[r * TN + tid] = 0;
    }
    float xn = 0.f;

    // distances to every (restart, centroid) pair, G pairs at a time
    for (int g0 = 0; g0 < RK; g0 += G) {
      float acc[G];
#pragma unroll
      for (int p = 0; p < G; ++p) acc[p] = 0.f;
      float cacc = 0.f;
      for (int f0 = 0; f0 < F; f0 += FC) {
        __syncthreads();
        load_tile<BF16>(x, xs, row0, f0, N, F);
        load_centroids(c, cs, g0, f0, RK, F);
        __syncthreads();
        if (tid < G) {
          for (int ff = 0; ff < FC; ++ff)
            cacc = fmaf(cs[tid * FC + ff], cs[tid * FC + ff], cacc);
        }
        const float* xr = xs + tid * XS;
        for (int ff = 0; ff < FC; ff += 4) {
          const float x0 = xr[ff], x1 = xr[ff + 1], x2 = xr[ff + 2],
                      x3 = xr[ff + 3];
          if (g0 == 0) {
            xn = fmaf(x0, x0, xn);
            xn = fmaf(x1, x1, xn);
            xn = fmaf(x2, x2, xn);
            xn = fmaf(x3, x3, xn);
          }
#pragma unroll
          for (int p = 0; p < G; ++p) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + p * FC + ff);
            acc[p] = fmaf(x0, cv.x, acc[p]);
            acc[p] = fmaf(x1, cv.y, acc[p]);
            acc[p] = fmaf(x2, cv.z, acc[p]);
            acc[p] = fmaf(x3, cv.w, acc[p]);
          }
        }
      }
      if (tid < G && g0 + tid < RK) cn[g0 + tid] = cacc;
      __syncthreads();
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const int gp = g0 + p;
        if (gp < RK) {
          const int r = gp / K, k = gp % K;
          const float d = xn - 2.0f * acc[p] + cn[gp];
          // strict <: the first (lowest) centroid index wins ties
          if (d < best_d[r * TN + tid]) {
            best_d[r * TN + tid] = d;
            labs[r * TN + tid] = k;
          }
        }
      }
    }
    for (int r = 0; r < R; ++r) {
      if (valid) {
        labels[(size_t)r * N + row] = labs[r * TN + tid];
        dist[(size_t)r * N + row] = best_d[r * TN + tid];
      } else {
        labs[r * TN + tid] = -1;      // masked out of the update
      }
    }
    __syncthreads();
    if constexpr (UPDATE) {    // kmeans_assign stops at labels and dist
      // counts: thread i < RK owns (restart, centroid) pair i
#pragma unroll
      for (int j = 0; j < CNT; ++j) {
        const int i = tid + j * TN;
        if (i < RK) {
          const int* lr = labs + (i / K) * TN;
          const int k = i % K;
          for (int rr = 0; rr < TN; ++rr)
            cnt[j] += (lr[rr] == k) ? 1.f : 0.f;
        }
      }
      __syncthreads();    // labs and best_d are reset by the next tile
    }
  }
  if constexpr (UPDATE) {    // kmeans_assign has no update
#pragma unroll
    for (int j = 0; j < CNT; ++j) {
      const int i = tid + j * TN;
      if (i < RK) pcounts[(size_t)blockIdx.x * RK + i] = cnt[j];
    }

    // ---- update: this block's partial sums, one F-chunk at a time ----
    // The labels come back from global memory (this block wrote them above;
    // __syncthreads makes a block's global writes visible to the block).
    // sacc (R, K, FC) accumulates over all the block's tiles, rows in order,
    // then is stored once: no read-modify-write of global memory.
    float* ps = psums + (size_t)blockIdx.x * RK * F;
    const int col = tid % FC;
    for (int f0 = 0; f0 < F; f0 += FC) {
      __syncthreads();
      for (int i = tid; i < RK * FC; i += TN) sacc[i] = 0.f;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = tile * TN, row = row0 + tid;
        __syncthreads();
        load_tile<BF16>(x, xs, row0, f0, N, F);
        for (int r = 0; r < R; ++r)
          labs[r * TN + tid] = row < N ? labels[(size_t)r * N + row] : -1;
        __syncthreads();
        // thread (restart r, column col) adds each row into its centroid's
        // slot; eight rows' labels and values are read ahead of their adds
        for (int r = tid / FC; r < R; r += TN / FC) {
          const int* lr = labs + r * TN;
          float* sr = sacc + r * K * FC + col;
          for (int rr0 = 0; rr0 < TN; rr0 += 8) {
            int kk[8];
            float vv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              kk[u] = lr[rr0 + u];
              vv[u] = xs[(rr0 + u) * XS + col];
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (kk[u] >= 0) sr[kk[u] * FC] += vv[u];
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < RK * FC; i += TN) {
        const int gf = f0 + i % FC;
        if (gf < F) ps[(size_t)(i / FC) * F + gf] = sacc[i];
      }
    }
  }
}

// sums/counts = sum over blocks of the partial slices.  A block owns 32
// consecutive outputs (lane = output, coalesced); warp w sums blocks
// b = w, w + 8, ... and the 8 warp sums are added in warp order, so the
// order is fixed and the result identical from run to run.
constexpr int RED_WARPS = 8;

__global__ void __launch_bounds__(32 * RED_WARPS)
lloyd_reduce(const float* __restrict__ psums,
             const float* __restrict__ pcounts, int B, int RKF, int RK,
             float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ float part[RED_WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < RKF) {
    for (int b = w; b < B; b += RED_WARPS) s += psums[(size_t)b * RKF + e];
  } else if (e < RKF + RK) {
    for (int b = w; b < B; b += RED_WARPS)
      s += pcounts[(size_t)b * RK + (e - RKF)];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < RKF + RK) {
    float t = 0.f;
    for (int i = 0; i < RED_WARPS; ++i) t += part[i][lane];
    if (e < RKF) sums[e] = t;
    else counts[e - RKF] = t;
  }
}

template <bool BF16, bool UPDATE>
cudaError_t launch_partial(const void* x, const float* c, int N, int F, int K,
                           int R, int blocks, size_t smem, int* labels,
                           float* dist, float* psums, float* pcounts,
                           cudaStream_t stream) {
  auto kern = lloyd_partial<BF16, UPDATE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, TN, smem, stream>>>(x, c, N, F, K, R, labels, dist, psums,
                                     pcounts);
  return cudaGetLastError();
}

size_t partial_smem(int K, int R) {
  const int RK = R * K;
  return sizeof(float) * ((size_t)TN * XS + (size_t)(G > RK ? G : RK) * FC +
                          RK + (size_t)R * TN) +
         sizeof(int) * (size_t)R * TN;
}

}  // namespace

extern "C" {

// Rows per tile and the largest R and K one call takes (the wrapper reads
// these instead of repeating the numbers).
int lloyd_rows_per_tile() { return TN; }
int lloyd_max_restarts() { return MAXR; }
int lloyd_max_centroids() { return MAXK; }

// Scratch the wrapper must allocate: psums (blocks, R, K, F) and pcounts
// (blocks, R, K) float32, with blocks <= ceil(N / TN).
int lloyd_step(const void* x, int x_is_bf16, const float* c, int N, int F,
               int K, int R, int blocks, int* labels, float* dist,
               float* sums, float* counts, float* psums, float* pcounts,
               void* stream) {
  if (N <= 0 || F <= 0 || K <= 0 || K > MAXK || R <= 0 || R > MAXR ||
      blocks <= 0 || blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem(K, R);
  cudaError_t err =
      x_is_bf16
          ? launch_partial<true, true>(x, c, N, F, K, R, blocks, smem, labels,
                                       dist, psums, pcounts, s)
          : launch_partial<false, true>(x, c, N, F, K, R, blocks, smem,
                                        labels, dist, psums, pcounts, s);
  if (err != cudaSuccess) return (int)err;
  const int RK = R * K, RKF = RK * F;
  lloyd_reduce<<<(RKF + RK + 31) / 32, 32 * RED_WARPS, 0, s>>>(
      psums, pcounts, blocks, RKF, RK, sums, counts);
  return (int)cudaGetLastError();
}

// labels int32 (N,) and dist float32 (N,) of x (N, F) against c (K, F);
// blocks <= ceil(N / TN).
int kmeans_assign(const void* x, int x_is_bf16, const float* c, int N, int F,
                  int K, int blocks, int* labels, float* dist, void* stream) {
  if (N <= 0 || F <= 0 || K <= 0 || K > MAXK || blocks <= 0 ||
      blocks > (N + TN - 1) / TN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem(K, 1);
  cudaError_t err =
      x_is_bf16 ? launch_partial<true, false>(x, c, N, F, K, 1, blocks, smem,
                                              labels, dist, nullptr, nullptr, s)
                : launch_partial<false, false>(x, c, N, F, K, 1, blocks, smem,
                                               labels, dist, nullptr, nullptr,
                                               s);
  return (int)err;
}

}  // extern "C"
