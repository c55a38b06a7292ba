// Forward blockwise (flash) attention with causal, sliding-window and
// ragged-key masks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel).  Inputs: q (B, Sq, H, hd), k and v
// (B, Sk, H, hd), all float32 or all bfloat16, contiguous, with K/V
// already expanded to H heads (GQA is the caller's repeat).  Output o
// (B, Sq, H, hd) in q's type.  Per row: s = (q . k) * 1/sqrt(hd), masked
// entries set to NEG_INF = -1e30 (not -inf), an online softmax with a
// running max m, denominator l and accumulator acc in fp32, and
// o = acc / max(l, 1e-30), as the Pallas kernel does.  Masks: kpos < Sk;
// causal kpos <= qpos; window kpos > qpos - window when window > 0.
//
// A row that sees no key (with a window, a row q >= Sk - 1 + window) gets
// what the Pallas kernel gives it: there every score is NEG_INF, so every
// p = exp(0) = 1, the zero-padded keys of its key blocks count in l and
// corr stays 1, so o = sum_{k < Sk} v_k / Sk_pad, where Sk_pad is Sk
// rounded up to the Pallas key block min(128, max(Sk, 8)) (the caller
// passes it).  Both kernels end with that epilogue: a row whose running
// max is still NEG_INF after the key loop saw no key, and a block that
// holds such a row sums V's Sk rows of its head once (threads over
// head_dim columns, fp32) and writes sum / Sk_pad to those rows.
//
// What bounds it on an H100: 4*B*H*Sq*Sk*hd flops (about half of that
// under the causal mask) against reading q, k, v and writing o once.  At
// qwen2-0.5b's prefill (S = 4096, hd = 64, bf16, causal) that is about
// 1,000 flops per byte, so the operations bound it: 989 TFLOP/s on the
// bf16 tensor cores (67 TFLOP/s in fp32 on the CUDA cores).
//
// bf16 inputs: both products on the tensor cores (flash_fwd_mma).
//  * One block of 4 warps per (query tile of 64 rows, head, batch); warp w
//    owns query rows 16w..16w+15.  A loop over key tiles of 64 keys (32 at
//    hd > 128) inside the block replaces the TPU's sequential innermost
//    grid axis; m, l and the output accumulator stay in registers for the
//    whole loop.  Query tiles are walked from the last, so the longest
//    causal rows start first.  The tile sizes were picked by timing 4 or 8
//    warps against 64- or 128-key tiles on the H100 (PERF.md): 8 warps x
//    128 keys ran as fast at hd 64 and 128 and faster at hd 96,
//    but needs 255 registers and spills at hd 128.
//  * S = Q.K^T with mma.sync.m16n8k16 (bf16 in, fp32 accumulate): the
//    products of bf16 values are exact in fp32, as in the Pallas kernel,
//    which upcasts before its dot.  1/sqrt(hd) is applied to s in fp32
//    after the product (q * scale is not exact in bf16 for hd 96 or 128),
//    with log2(e) folded in so that p = exp2(s' - m') (ex2.approx, about
//    2^-22 relative).  Q's A fragments are loaded once (ldmatrix) and stay
//    in registers; K's B fragments come from shared memory by ldmatrix.
//  * P stays in registers: the m16n8 fp32 accumulator of S has, per
//    thread, the layout of the A operand of the next m16n8k16 product, so
//    the row max and sum take two quad shuffles and P feeds P.V directly
//    (V's B fragments by ldmatrix.trans).
//  * P in two bf16 terms.  A single bf16 P (2^-9 relative rounding of each
//    p) is not within one bf16 unit of the fp32 result where early causal
//    rows see few keys whose values cancel.  So p_hi = bf16(p) and
//    p_lo = bf16(p - p_hi), and P.V is two products into the same fp32
//    accumulator: about 16 bits of each p, at 1.5x the useful MMA work.
//    l is summed from the fp32 p.
//  * K and V tiles are copied as bf16 into shared memory with 16-byte
//    cp.async into a 2-stage ring: the next tile's copies are in flight
//    while this tile computes, with one __syncthreads per key tile.  Rows
//    past Sq or Sk are zero-filled by the copy (src-size 0).  Shared rows
//    are padded to round_up(hd, 16) + 8 bf16, an odd multiple of 16 bytes,
//    so the 8 rows of an ldmatrix phase fall in 8 different bank groups.
//    Where hd is not a multiple of 16 the contraction is zero-padded to
//    the next one in shared memory, which is exact.
//  * Masks only where needed: the causal, window and ragged-edge masks are
//    applied only on key tiles that cross a mask edge for some row of the
//    query tile; interior tiles run unmasked.  Key tiles that the causal
//    or window mask excludes for every row of the query tile are skipped.
//    For a row that sees a key this gives the Pallas kernel's result:
//    there p is not zeroed on masked entries, and a wholly masked tile seen
//    while m is still NEG_INF adds terms that corr = exp(NEG_INF - m)
//    wipes out later; a row that sees none takes the epilogue above.
//  * Instantiations by head_dim: hd 64, 96, 128 and 256 run with every
//    loop bound a constant (no branch inside the unrolled loops); other
//    multiples of 8 run padded in the next size up (64, 128 or 256).  Up to
//    hd 128 Q stays in registers; at hd > 128 (a 128-float accumulator per
//    thread) Q's fragments are read from shared memory at each step and
//    key tiles hold 32 keys.  ptxas gives the hd <= 128 instantiations
//    120-230 registers and no spill; hd 256 takes 255 registers and
//    spills a few bytes.
//  * Deterministic: no atomics, a fixed order of every sum.
//
// fp32 inputs: the CUDA-core kernel (flash_fwd_fp32).  One block of 128
// threads per 64-row query tile, the same key loop, masks and skipping;
// q scaled in fp32 before the product, fp32 tiles in shared memory
// (rows padded to hd + 1), thread (rg, cg) = (tid / 8, tid % 8) owns query
// rows 4rg..4rg+3 and key columns cg, cg+8, ...; p goes through shared
// memory to the P.V product.  It can reach at best the fp32 CUDA-core
// rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// cudaFuncSetAttribute(max dynamic shared memory) once per kernel and
// device, not on every launch.
template <typename Kern>
cudaError_t set_smem_once(Kern kern, int bytes,
                          std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------

// Tile sizes of the bf16 kernel (see the header): warps per block (16
// query rows each), and keys per tile for hd <= 128; hd > 128 takes
// 32-key tiles.
constexpr int MMA_WARPS = 4;
constexpr int MMA_BK = 64;
constexpr int BK_WIDE = 32;
constexpr int MMA_NT = 32 * MMA_WARPS;   // threads per block
constexpr int MMA_BQ = 16 * MMA_WARPS;   // query rows per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far under the bound for p <= 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as hi = bf16(x) and lo = bf16(x - hi), each packed in pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - __low2float(h),
                                       x1 - __high2float(h)));
}

// Copy rows [s0, s0 + ROWS) of head h of batch b of t (B, S, H, hd) into
// dst (row stride rs bf16) with cp.async; rows >= S are zero-filled.
// Thread i copies 16-byte chunk i % 8 (+ 8, ...) of rows i / 8 + k * NT/8.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* t,
                                          __nv_bfloat16* dst, int rs, int b,
                                          int h, int s0, int S, int H,
                                          int hd) {
  const size_t row_stride = (size_t)H * hd;
  const __nv_bfloat16* base = t + (size_t)b * S * row_stride + (size_t)h * hd;
  for (int c = threadIdx.x % 8; c < hd / 8; c += 8) {
#pragma unroll
    for (int r = threadIdx.x / 8; r < ROWS; r += NT / 8) {
      const int s = s0 + r;
      const bool valid = s < S;
      cp_async16(dst + r * rs + c * 8,
                 base + (size_t)(valid ? s : 0) * row_stride + c * 8, valid);
    }
  }
}

// The epilogue of a row that saw no key: colsum[d] = sum_{s < Sk} v[b, s,
// h, d] / sk_pad for d < hd, summed by the block's threads over columns
// (each column in key order, fp32) into shared memory.  Called by every
// thread of the block after the key loop, when some row of the block saw
// no key; ends with a barrier.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int NTH>
__device__ __forceinline__ void no_key_mean(const T* __restrict__ v,
                                            float* colsum, int b, int h,
                                            int Sk, int H, int hd,
                                            int sk_pad) {
  const size_t row_stride = (size_t)H * hd;
  const T* base = v + (size_t)b * Sk * row_stride + (size_t)h * hd;
  for (int d = threadIdx.x; d < hd; d += NTH) {
    float acc = 0.f;
    for (int s = 0; s < Sk; ++s) acc += to_f32(base[s * row_stride + d]);
    colsum[d] = acc / (float)sk_pad;
  }
  __syncthreads();
}

// HDP bounds hd (the accumulator holds HDP columns), BKT is the key tile,
// QREG keeps Q's A fragments in registers for the whole key loop.  PAD is
// false when hd == HDP: then every loop bound is a constant and the
// unrolled loops carry no branch; with PAD the contraction runs to
// round_up(hd, 16) and the output to hd.
// (__launch_bounds__ with 1 block per SM: ptxas may take up to 255
// registers, and at hd <= 128 it needs no spill.)
template <int HDP, int BKT, bool QREG, bool PAD>
__global__ void __launch_bounds__(MMA_NT, 1)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              int H, int Sq, int Sk, int hd_arg, float scale_log2, int causal,
              int window, int sk_pad) {
  constexpr int NT = MMA_NT, BQ = MMA_BQ;
  constexpr int NKS = HDP / 16;     // k-steps of Q.K^T over head_dim
  constexpr int NSN = BKT / 8;      // n8 tiles of S (keys)
  constexpr int NON = HDP / 8;      // n8 tiles of O (head_dim)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = PAD ? hd_arg : HDP;
  const int hdr = PAD ? (hd + 15) & ~15 : HDP;  // contraction padded to 16
  const int RS = hdr + 8;           // shared row stride in bf16
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ rows
  __nv_bfloat16* ks = qs + BQ * RS;             // 2 stages x BKT rows
  __nv_bfloat16* vs = ks + 2 * BKT * RS;        // 2 stages x BKT rows

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;        // mma fragment row / column

  // zero the padded contraction columns [hd, hdr) of every row once; the
  // copies never write them
  if (PAD && hdr > hd)
    for (int r = tid; r < BQ + 4 * BKT; r += NT)
      *reinterpret_cast<uint4*>(qs + r * RS + hd) = make_uint4(0, 0, 0, 0);

  // key tiles that hold a key some row of this query tile may see
  int k_lo = 0, k_hi = Sk;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (causal && q0 + BQ < k_hi) k_hi = q0 + BQ;
  const int kt_lo = k_lo / BKT, kt_hi = (k_hi + BKT - 1) / BKT;

  copy_tile<BQ, NT>(q, qs, RS, b, h, q0, Sq, H, hd);
  if (kt_lo < kt_hi) {
    copy_tile<BKT, NT>(k, ks, RS, b, h, kt_lo * BKT, Sk, H, hd);
    copy_tile<BKT, NT>(v, vs, RS, b, h, kt_lo * BKT, Sk, H, hd);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Q's A fragments: lane l addresses row l % 16, column 8 * (l / 16)
  const __nv_bfloat16* qa = qs + (warp * 16 + lane % 16) * RS + 8 * (lane / 16);
  uint32_t qf[QREG ? NKS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
      if (!PAD || 16 * kk < hdr) ldsm_x4(qf[kk], qa + 16 * kk);
  }

  // s' = (q.k) * scale * log2(e) in fp32; m is the running max of s' and
  // p = 2^(s' - m), so that a row that has seen only masked keys has
  // s' - m = NEG_INF - NEG_INF = 0 exactly, as in the Pallas kernel
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float acc[NON][4];
#pragma unroll
  for (int j = 0; j < NON; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // lane offsets of the ldmatrix addresses: K (keys x head_dim, B of
  // Q.K^T) and V (keys x head_dim, B of P.V, transposed)
  const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
  const int v_row = lane % 8 + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);
  const int row0 = q0 + warp * 16 + g;          // this thread's first row

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BKT;
    if (kt > kt_lo) {
      cp_async_wait_all();      // tile kt has landed (this thread's copies)
      __syncthreads();          // ... everyone's, and stage st ^ 1 is free
    }
    if (kt + 1 < kt_hi) {
      copy_tile<BKT, NT>(k, ks + (st ^ 1) * BKT * RS, RS, b, h, k0 + BKT, Sk,
                         H, hd);
      copy_tile<BKT, NT>(v, vs + (st ^ 1) * BKT * RS, RS, b, h, k0 + BKT, Sk,
                         H, hd);
      cp_async_commit();
    }
    const __nv_bfloat16* kst = ks + st * BKT * RS + k_row * RS + k_col;
    const __nv_bfloat16* vst = vs + st * BKT * RS + v_row * RS + v_col;

    // ---- S = Q.K^T (16 rows x BKT keys per warp) ----
    float s[NSN][4];
#pragma unroll
    for (int j = 0; j < NSN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      if (PAD && 16 * kk >= hdr) break;         // block-uniform
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, qa + 16 * kk);
      }
      uint32_t bk[NSN / 2][4];
#pragma unroll
      for (int jn = 0; jn < NSN / 2; ++jn)
        ldsm_x4(bk[jn], kst + 16 * jn * RS + 16 * kk);
#pragma unroll
      for (int jn = 0; jn < NSN / 2; ++jn) {
        mma_bf16(s[2 * jn], a, bk[jn][0], bk[jn][1]);
        mma_bf16(s[2 * jn + 1], a, bk[jn][2], bk[jn][3]);
      }
    }

    // ---- scale, mask on edge tiles, online softmax ----
#pragma unroll
    for (int j = 0; j < NSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    const bool edge = k0 + BKT > Sk || (causal && k0 + BKT - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NSN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + 8 * (e / 2);
          const int kpos = k0 + 8 * j + 2 * t4 + (e % 2);
          bool ok = kpos < Sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) s[j][e] = NEG_INF;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {               // rows g and g + 8
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NSN; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = ex2(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NSN; ++j) {
        const float p0 = ex2(s[j][2 * r] - mx);
        const float p1 = ex2(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        psum += p0 + p1;
      }
      l[r] = l[r] * corr + psum;
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < NON; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // ---- O += P.V, P as hi + lo bf16 A fragments from registers ----
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jd = 0; jd < NON / 2; ++jd) {
        if (PAD && 16 * jd >= hdr) break;       // block-uniform
        uint32_t bv[4];
        ldsm_x4_trans(bv, vst + 16 * kk * RS + 16 * jd);
        mma_bf16(acc[2 * jd], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * jd + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * jd], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * jd + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // rows that saw no key (m still NEG_INF; uniform over the quad)
  const bool none0 = m[0] == NEG_INF && row0 < Sq;
  const bool none1 = m[1] == NEG_INF && row0 + 8 < Sq;
  float* colsum = reinterpret_cast<float*>(smem_raw);
  const bool any_none = __syncthreads_or(none0 || none1);
  if (any_none) no_key_mean<__nv_bfloat16, NT>(v, colsum, b, h, Sk, H, hd,
                                               sk_pad);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qpos = row0 + 8 * r;
    const bool none = r ? none1 : none0;
    if (qpos < Sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
      __nv_bfloat16* dst = o + (((size_t)b * Sq + qpos) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < NON; ++j) {
        const int col = 8 * j + 2 * t4;
        if (!PAD || col < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              none ? __floats2bfloat162_rn(colsum[col], colsum[col + 1])
                   : __floats2bfloat162_rn(acc[j][2 * r] * inv,
                                           acc[j][2 * r + 1] * inv);
      }
    }
  }
}

template <int HDP, int BKT, bool QREG, bool PAD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Sq, int Sk, int hd, float scale,
                       int causal, int window, int sk_pad,
                       cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  const int rs = ((hd + 15) & ~15) + 8;
  const int smem = (int)sizeof(__nv_bfloat16) * (MMA_BQ + 4 * BKT) * rs;
  constexpr int smem_max = (int)sizeof(__nv_bfloat16) * (MMA_BQ + 4 * BKT) *
                           (HDP + 8);
  auto kern = flash_fwd_mma<HDP, BKT, QREG, PAD>;
  cudaError_t err = set_smem_once(kern, smem_max, attr_done);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + MMA_BQ - 1) / MMA_BQ, H, B);
  kern<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Sq, Sk, hd, scale * LOG2E, causal, window, sk_pad);
  return cudaGetLastError();
}

// hd 64, 96, 128 and 256 run with every bound constant; any other
// multiple of 8 runs padded in the next instantiation up.
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Sq, int Sk, int hd, float scale,
                         int causal, int window, int sk_pad, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_mma<64, MMA_BK, true, false>(q, k, v, o, B, H, Sq, Sk,
                                                 hd, scale, causal, window, sk_pad, s);
    case 96:
      return launch_mma<96, MMA_BK, true, false>(q, k, v, o, B, H, Sq, Sk,
                                                 hd, scale, causal, window, sk_pad, s);
    case 128:
      return launch_mma<128, MMA_BK, true, false>(q, k, v, o, B, H, Sq, Sk,
                                                  hd, scale, causal, window, sk_pad, s);
    case 256:
      return launch_mma<256, BK_WIDE, false, false>(
          q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
  }
  if (hd < 64)
    return launch_mma<64, MMA_BK, true, true>(q, k, v, o, B, H, Sq, Sk, hd,
                                              scale, causal, window, sk_pad, s);
  if (hd < 128)
    return launch_mma<128, MMA_BK, true, true>(q, k, v, o, B, H, Sq, Sk, hd,
                                               scale, causal, window, sk_pad, s);
  return launch_mma<256, BK_WIDE, false, true>(
      q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
}

// ------------------------------------------------------------------------
// fp32: CUDA cores
// ------------------------------------------------------------------------

constexpr int BQ = 64;            // query rows per block
constexpr int NT = 128;           // threads per block
constexpr int BK32 = 64;          // keys per tile
constexpr int RPT = 4;            // query rows per thread
constexpr int CPT = BK32 / 8;     // key columns per thread
constexpr int PS = BK32 + 1;      // padded row stride of the p tile

// Stage rows [s0, s0 + 64) of head h of batch b of t (B, S, H, hd) into
// dst with row stride ds, times mul; rows >= S read as 0.
__device__ __forceinline__ void stage(const float* t, float* dst, int ds,
                                      int b, int h, int s0, int S, int H,
                                      int hd, float mul) {
  for (int i = threadIdx.x; i < 64 * hd; i += NT) {
    const int r = i / hd, d = i % hd, s = s0 + r;
    dst[r * ds + d] =
        s < S ? t[(((size_t)b * S + s) * H + h) * hd + d] * mul : 0.f;
  }
}

// HDMAX bounds hd (a multiple of 8, at most HDMAX): it sizes the
// per-thread accumulator, acc[RPT][HDMAX / 8].
template <int HDMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H,
               int Sq, int Sk, int hd, float scale, int causal, int window,
               int sk_pad) {
  constexpr int NJ = HDMAX / 8;
  extern __shared__ float smem[];
  const int QS = hd + 1;
  float* qs = smem;                        // BQ x QS, scaled q
  float* ks = qs + BQ * QS;                // BK32 x QS
  float* vs = ks + BK32 * QS;              // BK32 x hd
  float* ps = vs + BK32 * hd;              // BQ x PS

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;

  // q * scale in fp32, as the Pallas kernel scales before the product
  stage(q, qs, QS, b, h, q0, Sq, H, hd, scale);

  int k_lo = 0, k_hi = Sk;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (causal && q0 + BQ < k_hi) k_hi = q0 + BQ;
  const int kt_lo = k_lo / BK32, kt_hi = (k_hi + BK32 - 1) / BK32;

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();                   // the last tile's k, v and p are used
    stage(k, ks, QS, b, h, k0, Sk, H, hd, 1.f);
    stage(v, vs, hd, b, h, k0, Sk, H, hd, 1.f);
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

    for (int kk = 0; kk < BK32; ++kk) {
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

  // rows that saw no key (m still NEG_INF; uniform over the row's lanes)
  bool none[RPT], mine = false;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    none[i] = m[i] == NEG_INF && q0 + rg * RPT + i < Sq;
    mine = mine || none[i];
  }
  float* colsum = smem;
  if (__syncthreads_or(mine))
    no_key_mean<float, NT>(v, colsum, b, h, Sk, H, hd, sk_pad);

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
        if (8 * j < hd)
          o[base + cg + 8 * j] =
              none[i] ? colsum[cg + 8 * j] : acc[i][j] * inv;
    }
  }
}

template <int HDMAX>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int hd, float scale,
                        int causal, int window, int sk_pad,
                        cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  const int smem = (int)sizeof(float) * ((BQ + BK32) * (hd + 1) +
                                         BK32 * hd + BQ * PS);
  constexpr int smem_max = (int)sizeof(float) * ((BQ + BK32) * (HDMAX + 1) +
                                                 BK32 * HDMAX + BQ * PS);
  auto kern = flash_fwd_fp32<HDMAX>;
  cudaError_t err = set_smem_once(kern, smem_max, attr_done);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk, hd,
      scale, causal, window, sk_pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q (B, Sq, H, hd), k, v (B, Sk, H, hd) and o
// (B, Sq, H, hd), all of one type (bf16 when is_bf16), contiguous;
// 8 <= hd <= 256, hd % 8 == 0; scale = 1/sqrt(hd) as the caller rounds it
// (of the true hd where the caller zero-padded it to a multiple of 8).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int is_bf16, int B, int H, int Sq, int Sk, int hd,
                    float scale, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd % 8 != 0 ||
      hd > 256 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Sk rounded up to the Pallas kernel's key block, min(128, max(Sk, 8))
  const int pallas_bk = Sk < 8 ? 8 : (Sk < 128 ? Sk : 128);
  const int sk_pad = (Sk + pallas_bk - 1) / pallas_bk * pallas_bk;
  if (is_bf16)
    return (int)dispatch_mma(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                             window, sk_pad, s);
  if (hd <= 64)
    return (int)launch_fp32<64>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                                window, sk_pad, s);
  if (hd <= 128)
    return (int)launch_fp32<128>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                                 window, sk_pad, s);
  return (int)launch_fp32<256>(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                               window, sk_pad, s);
}

}  // extern "C"
