// Lloyd step (assign + update) for stage-1 k-means, batched over restarts,
// and its assign-only sibling, for Hopper (sm_90a).
//
// lloyd_step replaces the Pallas TPU kernel repro/kernels/kmeans.py::
// lloyd_step (body _lloyd_kernel).  Inputs: x (N, F) float32 or bfloat16,
// shared by all restarts; c (R, K, F) float32.  Outputs: labels int32
// (R, N), the min distance float32 (R, N), sums float32 (R, K, F) =
// onehot^T x and counts float32 (R, K).
//
// kmeans_assign replaces repro/kernels/kmeans.py::kmeans_assign (body
// _assign_kernel): labels int32 (N,) and min distances float32 (N,) of x
// (N, F) against one c (K, F).  It is assign_rows at R = 1: one launch.
//
// What bounds them on an H100: one step costs 2*N*K*F*R FMA-flops and
// must read x once (N*F*4 bytes).  At the fleet shape (N=100k, F=256,
// K=10, R=4) both give about 31 us on a 700 W H100 SXM.  At stage 1's
// N = 100 the work is about 1 MFLOP and latency sets the time, so the
// design spreads the rows over many SMs instead of serialising phases in
// one block.
//
// Design:
//  * assign_rows: one warp owns RW = 4 rows, a block AW = 4 warps, so
//    N = 100 runs as 25 warps on 7 SMs.  Lanes stride over F (feature
//    lane + 32 j), so every load of x and c is coalesced; the warp keeps
//    its rows' features in registers, FCH = 256 at a time, and reads the
//    centroids through L1 (c is 40 KB at stage 1).  For each group of
//    G = 8 (restart, centroid) pairs a lane holds 32 running dot products
//    (8 pairs x 4 rows) and 8 running ||c||^2, in fp32 FMA on the CUDA
//    cores (no TF32, no tensor cores); one halving exchange (lane_sum: 31
//    shuffles for 32 sums) leaves lane l the full x.c of pair l / 4 and
//    row l % 4, and a second its pair's ||c||^2.  The distance is
//    ||x||^2 - 2 x.c + ||c||^2, the plain version's decomposition; lanes
//    (row, restart) then scan the group's pairs in index order with a
//    strict <, so the first centroid wins a tie.  Pairs past R*K and rows
//    past N are masked.
//  * update_chunk: a block of UW = 8 warps owns TR = 128 rows and FCU = 64
//    feature columns (two a lane), all restarts.  It stages the x tile and
//    the rows' labels in shared memory; warp r lists restart r's rows of
//    each centroid in ascending order (__match_any_sync ranks, no
//    atomics); then the warps share the (restart, centroid) pairs, each
//    lane adding the pair's rows in list order into its two columns.
//    Counts are the list lengths, written by the blocks of column group 0.
//    With one chunk (N <= 128, every stage-1 call) it writes sums and
//    counts directly: two launches per step.  With more it writes the
//    chunk's slice of a (chunks, R, K, F) scratch, and lloyd_reduce adds
//    the slices in a fixed order.
//  * At the fleet shape the step reads x twice (assign, update), and the
//    assign's exchange and scan cost about as much as its FMAs; a pass
//    that reads x once is the next step (ROADMAP queue 2).
//
// Exactness (stage 1's restarts tie exactly in the reference when they
// reach one partition under permuted ids, and the port keeps the tie):
//  * every x.c, ||x||^2 and ||c||^2 is a per-lane FMA chain over the
//    lane's features in ascending order, then the same tree over lanes
//    (lane bit 4 first, then 3, 2, 1, 0), whatever slot the pair sits in;
//  * each centroid's sum adds its rows in ascending row order within a
//    chunk and the chunks in a fixed order, whatever the centroid's id;
//  * no float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAXR = 4;          // restarts per call (stage 1 runs 4)
constexpr int MAXK = 128;        // centroids per restart

constexpr int AW = 4;            // warps per assign block
constexpr int RW = 4;            // rows per warp
constexpr int G = 8;             // (restart, centroid) pairs per group
constexpr int FPL = 8;           // features per lane per chunk
constexpr int FCH = 32 * FPL;    // features per chunk
static_assert(G * RW == 32, "one reduced dot product per lane");

constexpr int TR = 128;          // rows per update chunk
constexpr int CPL = 2;           // feature columns per lane
constexpr int FCU = 32 * CPL;    // feature columns per update block
constexpr int UW = 8;            // warps per update block
static_assert(UW >= MAXR, "one warp lists each restart");

template <bool BF16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

// Sums over the warp's lanes of V values that every lane holds in v[0..V):
// each step over lane bit OFF sends half of the values to the partner and
// adds the half it receives, so lane l ends with the sum of value l >> (5 -
// log2 V); once one value is left, the steps over the lower bits add it in
// full.  Every value's sum is taken in the same tree over lanes (bit 4
// first, then 3, 2, 1, 0), whatever its index.  32 values: 31 shuffles.
template <int OFF, int V, int L>
__device__ __forceinline__ float lane_sum(float (&v)[L], int lane) {
  if constexpr (OFF == 0) {
    return v[0];
  } else if constexpr (V > 1) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float send = hi ? v[i] : v[i + V / 2];
      const float keep = hi ? v[i + V / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    return lane_sum<OFF / 2, V / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], OFF);
    return lane_sum<OFF / 2, 1>(v, lane);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(32 * AW)
assign_rows(const void* __restrict__ x, const float* __restrict__ c, int N,
            int F, int K, int R, int* __restrict__ labels,
            float* __restrict__ dist) {
  __shared__ float dsm[AW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * AW + w) * RW;
  if (row0 >= N) return;            // a whole warp; no block barrier below
  const int RK = R * K;
  // lane t < RW * R keeps the running best of row t % RW, restart t / RW
  const int my_r = lane % RW, my_rs = lane / RW;
  const int k_lo = my_rs * K, k_hi = k_lo + K;
  float best = INFINITY;
  int best_k = 0;

  float xv[RW][FPL];
  float xn[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    xn[r] = 0.f;
#pragma unroll
    for (int j = 0; j < FPL; ++j) xv[r][j] = 0.f;
  }
  for (int g0 = 0; g0 < RK; g0 += G) {
    float acc[G * RW], cc[G];
#pragma unroll
    for (int i = 0; i < G * RW; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G; ++p) cc[p] = 0.f;
    for (int f0 = 0; f0 < F; f0 += FCH) {
      if (g0 == 0 || F > FCH) {       // one chunk stays in registers
#pragma unroll
        for (int r = 0; r < RW; ++r) {
#pragma unroll
          for (int j = 0; j < FPL; ++j) {
            const int row = row0 + r, f = f0 + lane + 32 * j;
            xv[r][j] = (row < N && f < F)
                           ? load_x<BF16>(x, (size_t)row * F + f) : 0.f;
          }
        }
        if (g0 == 0) {
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int j = 0; j < FPL; ++j)
              xn[r] = fmaf(xv[r][j], xv[r][j], xn[r]);
        }
      }
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const float* cp = c + (size_t)min(g0 + p, RK - 1) * F;
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const int f = f0 + lane + 32 * j;
          const float cv = f < F ? __ldg(cp + f) : 0.f;
          cc[p] = fmaf(cv, cv, cc[p]);
#pragma unroll
          for (int r = 0; r < RW; ++r)
            acc[p * RW + r] = fmaf(xv[r][j], cv, acc[p * RW + r]);
        }
      }
    }
    // lane l: x.c of pair g0 + l / RW and row l % RW, ||c||^2 of its pair
    const float dot = lane_sum<16, G * RW>(acc, lane);
    const float cn = lane_sum<16, G>(cc, lane);
    if (g0 == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float t[1] = {xn[r]};
        xn[r] = lane_sum<16, 1>(t, lane);
      }
    }
    float xr = xn[0];
#pragma unroll
    for (int r = 1; r < RW; ++r)
      if (my_r == r) xr = xn[r];
    dsm[w][lane] = xr - 2.0f * dot + cn;
    __syncwarp();
    if (lane < RW * R) {
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const int gp = g0 + p;
        // strict <: the first (lowest) centroid index wins ties
        if (gp >= k_lo && gp < k_hi && dsm[w][p * RW + my_r] < best) {
          best = dsm[w][p * RW + my_r];
          best_k = gp - k_lo;
        }
      }
    }
    __syncwarp();
  }
  if (lane < RW * R && row0 + my_r < N) {
    labels[(size_t)my_rs * N + row0 + my_r] = best_k;
    dist[(size_t)my_rs * N + row0 + my_r] = best;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(32 * UW)
update_chunk(const void* __restrict__ x, const int* __restrict__ labels,
             int N, int F, int K, int R, float* __restrict__ sums,
             float* __restrict__ counts) {
  __shared__ float xs[TR * FCU];
  __shared__ int lab[MAXR][TR];
  __shared__ int list[MAXR][TR];
  __shared__ int start[MAXR][MAXK + 1];
  __shared__ int seen[MAXR][MAXK];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = blockIdx.y * TR, col = blockIdx.x * FCU + lane;
  const int rows = min(TR, N - row0);
  const int RK = R * K;

  // ---- the tile: x[row0, row0 + rows) x this block's FCU columns (the
  // lane's are col + 32 u), and the labels
#pragma unroll
  for (int q = 0; q < TR / UW; ++q) {
    const int i = w + q * UW;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int f = col + 32 * u;
      xs[i * FCU + 32 * u + lane] = (i < rows && f < F)
          ? load_x<BF16>(x, (size_t)(row0 + i) * F + f) : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < MAXR * TR / (32 * UW); ++q) {
    const int i = threadIdx.x + q * 32 * UW, r = i / TR, j = i % TR;
    if (r < R) lab[r][j] = j < rows ? labels[(size_t)r * N + row0 + j] : -1;
  }
  __syncthreads();

  // ---- warp r lists restart r's rows of centroid k in ascending order at
  // list[r][start[r][k] .. start[r][k + 1])
  if (w < R) {
    int* st = start[w];
    int* sn = seen[w];
    int* ls = list[w];
    const int* lb = lab[w];
    for (int k = lane; k <= K; k += 32) st[k] = 0;
    for (int k = lane; k < K; k += 32) sn[k] = 0;
    __syncwarp();
    for (int i0 = 0; i0 < rows; i0 += 32) {
      const int l = i0 + lane < rows ? lb[i0 + lane] : -1;
      const unsigned peers = __match_any_sync(FULL, l);
      if (l >= 0 && lane == __ffs(peers) - 1) st[l + 1] += __popc(peers);
      __syncwarp();
    }
    if (lane == 0)
      for (int k = 1; k <= K; ++k) st[k] += st[k - 1];
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = 0; i0 < rows; i0 += 32) {
      const int i = i0 + lane;
      const int l = i < rows ? lb[i] : -1;
      const unsigned peers = __match_any_sync(FULL, l);
      if (l >= 0) ls[st[l] + sn[l] + __popc(peers & below)] = i;
      __syncwarp();
      if (l >= 0 && lane == __ffs(peers) - 1) sn[l] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- each (restart, centroid) adds its rows in list order, a lane into
  // its columns
  float* out = sums + (size_t)blockIdx.y * RK * F;
  for (int t = w; t < RK; t += UW) {
    const int r = t / K, k = t - r * K;
    const int b = start[r][k], e = start[r][k + 1];
    const int* ls = list[r];
    float s[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) s[u] = 0.f;
#pragma unroll 8
    for (int i = b; i < e; ++i) {
      const float* xr = xs + ls[i] * FCU + lane;
#pragma unroll
      for (int u = 0; u < CPL; ++u) s[u] += xr[32 * u];
    }
#pragma unroll
    for (int u = 0; u < CPL; ++u)
      if (col + 32 * u < F) out[(size_t)t * F + col + 32 * u] = s[u];
    if (blockIdx.x == 0 && lane == 0)
      counts[(size_t)blockIdx.y * RK + t] = (float)(e - b);
  }
}

// sums/counts = sum over chunks of the partial slices.  A block owns 32
// consecutive outputs (lane = output, coalesced); warp w sums chunks
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

template <bool BF16>
cudaError_t launch_assign(const void* x, const float* c, int N, int F, int K,
                          int R, int* labels, float* dist, cudaStream_t s) {
  const int blocks = (N + AW * RW - 1) / (AW * RW);
  assign_rows<BF16><<<blocks, 32 * AW, 0, s>>>(x, c, N, F, K, R, labels,
                                               dist);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_update(const void* x, const int* labels, int N, int F,
                          int K, int R, float* sums, float* counts,
                          cudaStream_t s) {
  // x: column groups, y: row chunks
  const dim3 grid((F + FCU - 1) / FCU, (N + TR - 1) / TR);
  update_chunk<BF16><<<grid, 32 * UW, 0, s>>>(x, labels, N, F, K, R, sums,
                                              counts);
  return cudaGetLastError();
}

bool shape_ok(int N, int F, int K, int R) {
  return N > 0 && F > 0 && K > 0 && K <= MAXK && R > 0 && R <= MAXR &&
         (N + TR - 1) / TR <= 65535;
}

}  // namespace

extern "C" {

// Rows per update chunk and the largest R and K one call takes (the
// wrapper reads these instead of repeating the numbers).
int lloyd_rows_per_chunk() { return TR; }
int lloyd_max_restarts() { return MAXR; }
int lloyd_max_centroids() { return MAXK; }

// With chunks = ceil(N / TR) > 1 the wrapper allocates psums (chunks, R,
// K, F) and pcounts (chunks, R, K) float32; with one chunk both may be
// null.
int lloyd_step(const void* x, int x_is_bf16, const float* c, int N, int F,
               int K, int R, int* labels, float* dist, float* sums,
               float* counts, float* psums, float* pcounts, void* stream) {
  const int chunks = N > 0 ? (N + TR - 1) / TR : 0;
  if (!shape_ok(N, F, K, R) || (chunks > 1 && (!psums || !pcounts)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* us = chunks > 1 ? psums : sums;
  float* uc = chunks > 1 ? pcounts : counts;
  cudaError_t err =
      x_is_bf16 ? launch_assign<true>(x, c, N, F, K, R, labels, dist, s)
                : launch_assign<false>(x, c, N, F, K, R, labels, dist, s);
  if (err != cudaSuccess) return (int)err;
  err = x_is_bf16 ? launch_update<true>(x, labels, N, F, K, R, us, uc, s)
                  : launch_update<false>(x, labels, N, F, K, R, us, uc, s);
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int RK = R * K, RKF = RK * F;
  lloyd_reduce<<<(RKF + RK + 31) / 32, 32 * RED_WARPS, 0, s>>>(
      psums, pcounts, chunks, RKF, RK, sums, counts);
  return (int)cudaGetLastError();
}

// labels int32 (N,) and dist float32 (N,) of x (N, F) against c (K, F).
int kmeans_assign(const void* x, int x_is_bf16, const float* c, int N, int F,
                  int K, int* labels, float* dist, void* stream) {
  if (!shape_ok(N, F, K, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16
                   ? launch_assign<true>(x, c, N, F, K, 1, labels, dist, s)
                   : launch_assign<false>(x, c, N, F, K, 1, labels, dist, s));
}

}  // extern "C"
