// Forward blockwise (flash) attention with causal, sliding-window and
// ragged-key masks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel).  Inputs: q (B, Sq, H, hd), k and v
// (B, Sk, H, hd), all float32 or all bfloat16, contiguous, with K/V
// already expanded to H heads (GQA is the caller's repeat).  Output o
// (B, Sq, H, hd) in q's type.  Per row: s = (q * 1/sqrt(hd)) . k, masked
// entries set to NEG_INF = -1e30 (not -inf), an online softmax with a
// running max m, denominator l and accumulator acc in fp32, and
// o = acc / max(l, 1e-30), as the Pallas kernel does.  Masks: kpos < Sk;
// causal kpos <= qpos; window kpos > qpos - window when window > 0.
//
// What bounds it on an H100: 4*B*H*Sq*Sk*hd flops (about half of that
// under the causal mask) against reading q, k, v and writing o once.  At
// qwen2-0.5b's prefill (S = 4096, hd = 64, bf16, causal) that is about
// 1,000 flops per byte, so the operations bound it: 989 TFLOP/s on the
// bf16 tensor cores, 67 TFLOP/s in fp32 on the CUDA cores.  This first
// kernel runs on the CUDA cores in fp32 (products of bf16 inputs are
// exact in fp32), so it can reach at best the fp32 rate; wgmma and TMA
// are a later step.
//
// Design (right and simple first):
//  * One block per (query tile of BQ = 64 rows, head, batch), 128 threads.
//    A loop over key tiles of BK = 64 inside the block replaces the TPU's
//    sequential innermost grid axis; m, l and acc stay in registers for
//    the whole loop.  Query tiles are walked from the last, so the
//    longest causal rows start first.
//  * q, k and v are read in place from the (B, S, H, hd) layout, with no
//    transpose and no padding copy: rows past Sq or Sk read as zero and
//    the ragged key edge is masked in the kernel.
//  * The q tile is scaled and kept in shared memory; each key tile's k and
//    v rows are staged beside it.  Thread (rg, cg) = (tid / 8, tid % 8)
//    owns query rows 4rg..4rg+3 and key columns cg, cg+8, ..., so the 8
//    lanes of a row group reduce a row's max with three shuffles, and each
//    thread keeps its own share of l (all lanes rescale by the same
//    correction, so the shares add up at the end).
//  * p goes through shared memory to the P.V product; thread (rg, cg)
//    accumulates output columns cg, cg+8, ... of its 4 rows.
//  * Key tiles that the causal or window mask excludes for every row of
//    the query tile are skipped.  For a row that sees at least one key
//    this gives the Pallas kernel's result: there p is not zeroed on
//    masked entries, and a wholly masked tile seen while m is still
//    NEG_INF adds terms that corr = exp(NEG_INF - m) wipes out later.
//  * Shared-memory rows of q and k are padded to hd + 1 floats, so the 8
//    column lanes of a warp read 8 different banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // threads per block
constexpr int RPT = 4;          // query rows per thread
constexpr int CPT = BK / 8;     // key columns per thread
constexpr int PS = BK + 1;      // padded row stride of the p tile
constexpr float NEG_INF = -1e30f;

template <bool BF16>
__device__ __forceinline__ float load(const void* p, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <bool BF16>
__device__ __forceinline__ void store(void* p, size_t i, float v) {
  if (BF16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

// Stage rows [s0, s0 + 64) of head h of batch b of t (B, S, H, hd) into
// dst with row stride ds, times mul; rows >= S read as 0.
template <bool BF16>
__device__ __forceinline__ void stage(const void* t, float* dst, int ds,
                                      int b, int h, int s0, int S, int H,
                                      int hd, float mul) {
  for (int i = threadIdx.x; i < 64 * hd; i += NT) {
    const int r = i / hd, d = i % hd, s = s0 + r;
    dst[r * ds + d] =
        s < S ? load<BF16>(t, (((size_t)b * S + s) * H + h) * hd + d) * mul
              : 0.f;
  }
}

// HDMAX bounds hd (a multiple of 8, at most HDMAX): it sizes the
// per-thread accumulator, acc[RPT][HDMAX / 8].
template <bool BF16, int HDMAX>
__global__ void __launch_bounds__(NT)
flash_fwd(const void* __restrict__ q, const void* __restrict__ k,
          const void* __restrict__ v, void* __restrict__ o, int H, int Sq,
          int Sk, int hd, float scale, int causal, int window) {
  constexpr int NJ = HDMAX / 8;
  extern __shared__ float smem[];
  const int QS = hd + 1;
  float* qs = smem;                        // BQ x QS, scaled q
  float* ks = qs + BQ * QS;                // BK x QS
  float* vs = ks + BK * QS;                // BK x hd
  float* ps = vs + BK * hd;                // BQ x PS

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;

  // q * scale in fp32, as the Pallas kernel scales before the product
  stage<BF16>(q, qs, QS, b, h, q0, Sq, H, hd, scale);

  // key tiles that hold a key some row of this query tile may see
  int k_lo = 0, k_hi = Sk;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (causal && q0 + BQ < k_hi) k_hi = q0 + BQ;
  const int kt_lo = k_lo / BK, kt_hi = (k_hi + BK - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // the last tile's k, v and p are used
    stage<BF16>(k, ks, QS, b, h, k0, Sk, H, hd, 1.f);
    stage<BF16>(v, vs, hd, b, h, k0, Sk, H, hd, 1.f);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(rg * RPT + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i, qpos = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + cg + 8 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's max over its 8 lanes (lanes 8rg'..8rg'+7 of the warp)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ps[r * PS + cg + 8 * j] = p;
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(rg * RPT + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (8 * j < hd) {              // warp-uniform: hd is a multiple of 8
          const float vv = vs[kk * hd + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int qpos = q0 + rg * RPT + i;
    if (qpos < Sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
      const size_t base = (((size_t)b * Sq + qpos) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (8 * j < hd) store<BF16>(o, base + cg + 8 * j, acc[i][j] * inv);
    }
  }
}

template <bool BF16, int HDMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Sk, int hd, float scale,
                   int causal, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (hd + 1) + (size_t)BK * hd +
                       (size_t)BQ * PS);
  auto kern = flash_fwd<BF16, HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(q, k, v, o, H, Sq, Sk, hd, scale, causal,
                                   window);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Sq, int Sk, int hd, float scale,
                     int causal, int window, cudaStream_t s) {
  if (hd <= 64)
    return launch<BF16, 64>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                            window, s);
  if (hd <= 128)
    return launch<BF16, 128>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                             window, s);
  return launch<BF16, 256>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                           window, s);
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q (B, Sq, H, hd), k, v (B, Sk, H, hd) and o
// (B, Sq, H, hd), all of one type (bf16 when is_bf16), contiguous;
// 8 <= hd <= 256, hd % 8 == 0; scale = 1/sqrt(hd) as the caller rounds it.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int is_bf16, int B, int H, int Sq, int Sk, int hd,
                    float scale, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd % 8 != 0 ||
      hd > 256 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, o, B, H, Sq, Sk, hd, scale,
                                        causal, window, s)
                       : dispatch<false>(q, k, v, o, B, H, Sq, Sk, hd, scale,
                                         causal, window, s));
}

}  // extern "C"
