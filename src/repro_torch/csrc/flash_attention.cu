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
// bf16 tensor cores.  float32 inputs (about 500 flops per byte there) are
// bound by the float32-accurate rate of the tensor cores: three TF32
// products per product (below), 495 / 3 = 165 TFLOP/s, against 67 TFLOP/s
// on the CUDA cores.
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
// fp32 inputs: both products on the tensor cores in split TF32
// (flash_fwd_tf32), the bf16 kernel's structure with fp32 operands.
//  * Split TF32.  One TF32 product keeps 10 stored mantissa bits of each
//    operand (2^-11 relative); that alone exceeds the float32 bound (2.4-52x
//    at S 512, hd 64, by the emulation in tests/test_torch_flash.py).
//    So each operand x is split as hi = tf32(x) (round to nearest, ties
//    away, as cvt.rna.tf32.f32) and lo = x - hi (exact in fp32), and each
//    product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32 accumulators,
//    the small terms first (CUTLASS's 3xTF32).  The dropped a_lo.b_lo is
//    at most 2^-22 of a.b, and the tensor core reads lo to 10 bits (2^-21
//    of x): each product is within about 2^-20 of exact, far under the
//    1e-4 bound (tests/test_torch_gpu.py's witness: a single TF32 product
//    fails it).  q is scaled in fp32 and then split, as the Pallas kernel
//    scales it before the product; p is split in fp32 and l summed from
//    the fp32 p.
//  * Short sums on the tensor core.  The tensor core does not round its
//    fp32 accumulation to nearest (published measurements of earlier
//    NVIDIA parts find truncation), so a long chain of MMAs into one
//    accumulator drifts one way: with P.V summed over a whole 1,500-key
//    row in one accumulator the kernel read 0.060 of the bound at
//    whisper's encoder shape, 8x the CUDA-core kernel's 0.0076 (PERF.md).
//    So S's big terms (a_hi.b_hi) and small terms go to two accumulators,
//    added once a key tile, and each key tile's P.V is summed apart and
//    added to acc (acc * corr + tile, one fp32 fma), up to hd 128 (at hd
//    256 the tile sums do not fit in registers and P.V accumulates in
//    acc): 0.008 there.
//  * mma.sync.m16n8k8 (tf32 in, fp32 accumulate), 4 warps x 16 query rows
//    a block, key tiles of 64 keys at hd <= 64 and 32 above (the fp32
//    tiles take twice the bf16 ones' shared memory: 94 KB at hd 64, two
//    blocks an SM).  2 warps x 16 rows ran slower at every timed shape,
//    and 64-key tiles at hd 96 within 2 % (PERF.md).  Q.K^T contracts
//    head_dim in 16-column chunks: lane (g, t) reads 16 bytes at column
//    4t of rows g and g + 8 of Q and of key g of each n8 tile, and k step
//    s of the chunk takes columns 4t + 2s and 4t + 2s + 1 as its k indices
//    t and t + 4 (a fixed permutation of the contraction, the same for Q
//    and K).
//  * P in registers: S's accumulator holds keys 2t and 2t + 1 of each
//    8-key slice where P's A fragment wants k indices t and t + 4; the
//    kernel takes them as such and reads V's B fragment from rows 2t and
//    2t + 1, so P feeds P.V without a trip through shared memory.
//  * Q is split once into registers at hd <= 64; above that it is read and
//    split from shared memory at each key tile (at hd 96 Q in registers
//    took 255 registers and ran slower).  K and V are read from shared
//    memory as fp32 and split by each warp as it uses them.
//  * The rest as in flash_fwd_mma: a 2-stage cp.async ring (rows past Sq
//    or Sk zero-filled), masks only on key tiles that cross a mask edge,
//    wholly masked key tiles skipped, exp2 with log2(e) folded into s,
//    query tiles walked from the last, hd 64, 96, 128 and 256 with
//    constant loop bounds and other multiples of 8 padded, the no-key
//    epilogue, no atomics.  Shared strides (16 mod 32 floats for Q and K,
//    4 mod 16 for V) keep the fragment loads free of bank conflicts.
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
// fp32: tensor cores in split TF32
// ------------------------------------------------------------------------

// Warps per block of the fp32 kernel (16 query rows each); 2 warps were
// slower at every timed shape, the ragged one with its 108 blocks too.
constexpr int TF_WARPS = 4;
constexpr int TF_NT = 32 * TF_WARPS;     // threads per block
constexpr int TF_BQ = 16 * TF_WARPS;     // query rows per block
constexpr int TF_BK = 64;                // keys per tile at hd <= 64
constexpr int TF_BK_WIDE = 32;           // at hd > 64

// Shared row strides in floats for a contraction of hdr (a multiple of
// 16) columns: Q and K rows are read as 16-byte chunks (4t of row g), so
// their stride is 16 mod 32 floats and a quarter warp's 8 chunks fall in
// 8 bank groups; V is read one float a lane (row 2t, column g), so its
// stride is 4 mod 16 and 2t * stride + g covers the 32 banks.
__host__ __device__ constexpr int tf_qk_stride(int hdr) {
  return hdr % 32 ? hdr : hdr + 16;
}
__host__ __device__ constexpr int tf_v_stride(int hdr) { return hdr + 4; }
__host__ __device__ constexpr int tf_smem_bytes(int hdr, int bk) {
  return (int)sizeof(float) * ((TF_BQ + 2 * bk) * tf_qk_stride(hdr) +
                               2 * bk * tf_v_stride(hdr));
}

// d += a (16x8 tf32, row) . b (8x8 tf32, col), fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in split TF32: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small
// terms first (a_lo.b_lo is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to
// nearest, ties away from zero: half a unit of the 13 dropped bits added
// to the magnitude, then those bits cleared), lo = x - hi, exact in fp32.
// The tensor core reads lo as a TF32 operand, which drops its 13 low bits:
// at most 2^-10 of lo, which is at most 2^-11 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The A fragments of the two k8 steps of one 16-column chunk of q * scale,
// split: p points at row g, column 4t of the chunk (row g + 8 is 8 * rs
// further).  Step s takes columns 4t + 2s (k index t) and 4t + 2s + 1 (k
// index t + 4), so one 16-byte load per row serves both steps; K's B
// fragments take the same columns.
__device__ __forceinline__ void q_frags(const float* p, int rs, float scale,
                                        uint32_t (&hi)[2][4],
                                        uint32_t (&lo)[2][4]) {
  const float4 r0 = *reinterpret_cast<const float4*>(p);
  const float4 r1 = *reinterpret_cast<const float4*>(p + 8 * rs);
  const float x[2][4] = {{r0.x, r1.x, r0.y, r1.y}, {r0.z, r1.z, r0.w, r1.w}};
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[s][i] * scale, hi[s][i], lo[s][i]);
}

// One 16-column chunk of one n8 tile of S = Q.K^T: K's 16 bytes at kp
// (key g, column 4t), split, against Q's split A fragments of the chunk;
// a_hi.b_hi goes to sb, a_lo.b_hi + a_hi.b_lo to ss
__device__ __forceinline__ void s_chunk(float (&sb)[4], float (&ss)[4],
                                        const float* kp,
                                        const uint32_t (&ah)[2][4],
                                        const uint32_t (&al)[2][4]) {
  const float4 kr = *reinterpret_cast<const float4*>(kp);
  uint32_t bh[4], bl[4];
  split_tf32(kr.x, bh[0], bl[0]);
  split_tf32(kr.y, bh[1], bl[1]);
  split_tf32(kr.z, bh[2], bl[2]);
  split_tf32(kr.w, bh[3], bl[3]);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mma_tf32(ss, al[x], bh[2 * x], bh[2 * x + 1]);
    mma_tf32(ss, ah[x], bl[2 * x], bl[2 * x + 1]);
    mma_tf32(sb, ah[x], bh[2 * x], bh[2 * x + 1]);
  }
}

// Copy rows [s0, s0 + ROWS) of head h of batch b of t (B, S, H, hd) into
// dst (row stride rs floats) as 16-byte cp.async chunks; rows >= S are
// zero-filled.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_tile_f32(const float* t, float* dst,
                                              int rs, int b, int h, int s0,
                                              int S, int H, int hd) {
  const size_t row_stride = (size_t)H * hd;
  const float* base = t + (size_t)b * S * row_stride + (size_t)h * hd;
  const int cpr = hd / 4;                       // chunks per row
  for (int i = threadIdx.x; i < ROWS * cpr; i += NT) {
    const int r = i / cpr, c = i - r * cpr, s = s0 + r;
    const bool valid = s < S;
    cp_async16(dst + r * rs + 4 * c,
               base + (size_t)(valid ? s : 0) * row_stride + 4 * c, valid);
  }
}

// HDP bounds hd, BKT is the key tile, QREG keeps Q's split A fragments in
// registers for the whole key loop (else they are read and split from
// shared memory at each key tile), PAD as in flash_fwd_mma.  TLOC (hd <=
// 128) sums each key tile's P.V apart before adding it to acc.
template <int HDP, int BKT, bool QREG, bool PAD>
__global__ void __launch_bounds__(TF_NT)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H,
               int Sq, int Sk, int hd_arg, float scale, int causal,
               int window, int sk_pad) {
  constexpr int NT = TF_NT, BQ = TF_BQ;
  constexpr int NKC = HDP / 16;     // 16-column chunks of Q.K^T (2 k8 steps)
  constexpr int NSN = BKT / 8;      // n8 tiles of S (keys)
  constexpr int NON = HDP / 8;      // n8 tiles of O (head_dim)
  constexpr bool TLOC = HDP <= 128;  // key-tile sums of O apart (registers)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = PAD ? hd_arg : HDP;
  const int hdr = PAD ? (hd + 15) & ~15 : HDP;  // contraction padded to 16
  const int RS = tf_qk_stride(hdr), RV = tf_v_stride(hdr);
  float* qs = reinterpret_cast<float*>(smem_raw);  // BQ rows, stride RS
  float* ks = qs + BQ * RS;                      // 2 stages x BKT rows, RS
  float* vs = ks + 2 * BKT * RS;                 // 2 stages x BKT rows, RV

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;        // mma fragment row / column

  // zero the padded contraction columns [hd, hdr) of Q's and K's rows once
  // (hdr - hd is 8); the copies never write them
  if (PAD && hdr > hd)
    for (int r = tid; r < BQ + 2 * BKT; r += NT) {
      float4* z = reinterpret_cast<float4*>(qs + r * RS + hd);
      z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // key tiles that hold a key some row of this query tile may see
  int k_lo = 0, k_hi = Sk;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  if (causal && q0 + BQ < k_hi) k_hi = q0 + BQ;
  const int kt_lo = k_lo / BKT, kt_hi = (k_hi + BKT - 1) / BKT;

  copy_tile_f32<BQ, NT>(q, qs, RS, b, h, q0, Sq, H, hd);
  if (kt_lo < kt_hi) {
    copy_tile_f32<BKT, NT>(k, ks, RS, b, h, kt_lo * BKT, Sk, H, hd);
    copy_tile_f32<BKT, NT>(v, vs, RV, b, h, kt_lo * BKT, Sk, H, hd);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // q * scale in fp32 (the Pallas kernel scales before the product), split
  const float* qa = qs + (warp * 16 + g) * RS + 4 * t4;
  uint32_t qh[QREG ? NKC : 1][2][4], ql[QREG ? NKC : 1][2][4];
  if constexpr (QREG) {
#pragma unroll
    for (int c = 0; c < NKC; ++c)
      if (!PAD || 16 * c < hdr) q_frags(qa + 16 * c, RS, scale, qh[c], ql[c]);
  }

  // s' = s * log2(e) in fp32 with s = (q * scale).k; m is the running max
  // of s' and p = 2^(s' - m), so that a row that has seen only masked keys
  // has s' - m = NEG_INF - NEG_INF = 0 exactly, as in the Pallas kernel
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float acc[NON][4];
#pragma unroll
  for (int j = 0; j < NON; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // lane offsets: K row g of each n8 tile at column 4t of each chunk; V
  // rows 2t and 2t + 1 of each 8-key slice at column g of each n8 tile
  const int k_off = g * RS + 4 * t4, v_off = 2 * t4 * RV + g;
  const int row0 = q0 + warp * 16 + g;          // this thread's first row

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BKT;
    if (kt > kt_lo) {
      cp_async_wait_all();      // tile kt has landed (this thread's copies)
      __syncthreads();          // ... everyone's, and stage st ^ 1 is free
    }
    if (kt + 1 < kt_hi) {
      copy_tile_f32<BKT, NT>(k, ks + (st ^ 1) * BKT * RS, RS, b, h, k0 + BKT,
                             Sk, H, hd);
      copy_tile_f32<BKT, NT>(v, vs + (st ^ 1) * BKT * RV, RV, b, h, k0 + BKT,
                             Sk, H, hd);
      cp_async_commit();
    }
    const float* kst = ks + st * BKT * RS + k_off;
    const float* vst = vs + st * BKT * RV + v_off;

    // ---- S = Q.K^T (16 rows x BKT keys per warp), split TF32 ----
    // a_hi.b_hi into s, a_lo.b_hi + a_hi.b_lo into ss, added once a tile
    float s[NSN][4], ss[NSN][4];
#pragma unroll
    for (int j = 0; j < NSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ss[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      if (PAD && 16 * c >= hdr) break;          // block-uniform
      uint32_t ah[2][4], al[2][4];
      if constexpr (QREG) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[x][i] = qh[c][x][i];
            al[x][i] = ql[c][x][i];
          }
      } else {
        q_frags(qa + 16 * c, RS, scale, ah, al);
      }
#pragma unroll
      for (int j = 0; j < NSN; ++j)
        s_chunk(s[j], ss[j], kst + 8 * j * RS + 16 * c, ah, al);
    }
#pragma unroll
    for (int j = 0; j < NSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += ss[j][e];

    // ---- log2(e), mask on edge tiles, online softmax ----
#pragma unroll
    for (int j = 0; j < NSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= LOG2E;
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
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {               // rows g and g + 8
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NSN; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = ex2(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NSN; ++j) {
        const float p0 = ex2(s[j][2 * r] - mx);
        const float p1 = ex2(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        psum += p0 + p1;
      }
      l[r] = l[r] * corr[r] + psum;
      m[r] = mx;
    }

    // ---- O = O * corr + P.V, P split from registers ----
    // S's accumulator holds keys 2t and 2t + 1 of each 8-key slice; they
    // serve as k indices t and t + 4 of P's A fragment, and V's B
    // fragment reads rows 2t and 2t + 1 to match.  With TLOC this key
    // tile's products are summed apart in ot and added to acc in fp32.
    float ot[TLOC ? NON : 1][4];
#pragma unroll
    for (int jd = 0; jd < NON; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (TLOC)
          ot[jd][e] = 0.f;
        else
          acc[jd][e] *= corr[e / 2];
      }
#pragma unroll
    for (int kk = 0; kk < NSN; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kk][0], ph[0], pl[0]);       // row g,     key 2t
      split_tf32(s[kk][2], ph[1], pl[1]);       // row g + 8, key 2t
      split_tf32(s[kk][1], ph[2], pl[2]);       // row g,     key 2t + 1
      split_tf32(s[kk][3], ph[3], pl[3]);       // row g + 8, key 2t + 1
      const float* vr = vst + 8 * kk * RV;
#pragma unroll
      for (int jd = 0; jd < NON; ++jd) {
        if (PAD && 8 * jd >= hd) break;         // block-uniform
        uint32_t vh0, vl0, vh1, vl1;
        split_tf32(vr[8 * jd], vh0, vl0);
        split_tf32(vr[RV + 8 * jd], vh1, vl1);
        if constexpr (TLOC)
          mma_3xtf32(ot[jd], ph, pl, vh0, vh1, vl0, vl1);
        else
          mma_3xtf32(acc[jd], ph, pl, vh0, vh1, vl0, vl1);
      }
    }
    if constexpr (TLOC) {
#pragma unroll
      for (int jd = 0; jd < NON; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jd][e] = fmaf(acc[jd][e], corr[e / 2], ot[jd][e]);
    }
  }

  // rows that saw no key (m still NEG_INF; uniform over the quad)
  const bool none0 = m[0] == NEG_INF && row0 < Sq;
  const bool none1 = m[1] == NEG_INF && row0 + 8 < Sq;
  float* colsum = reinterpret_cast<float*>(smem_raw);
  const bool any_none = __syncthreads_or(none0 || none1);
  if (any_none) no_key_mean<float, NT>(v, colsum, b, h, Sk, H, hd, sk_pad);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qpos = row0 + 8 * r;
    const bool none = r ? none1 : none0;
    if (qpos < Sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
      float* dst = o + (((size_t)b * Sq + qpos) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < NON; ++j) {
        const int col = 8 * j + 2 * t4;
        if (!PAD || col < hd)
          *reinterpret_cast<float2*>(dst + col) =
              none ? make_float2(colsum[col], colsum[col + 1])
                   : make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
    }
  }
}

template <int HDP, int BKT, bool QREG, bool PAD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int hd, float scale,
                        int causal, int window, int sk_pad,
                        cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  auto kern = flash_fwd_tf32<HDP, BKT, QREG, PAD>;
  cudaError_t err = set_smem_once(kern, tf_smem_bytes(HDP, BKT), attr_done);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + TF_BQ - 1) / TF_BQ, H, B);
  kern<<<grid, TF_NT, tf_smem_bytes((hd + 15) & ~15, BKT), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk, hd,
      scale, causal, window, sk_pad);
  return cudaGetLastError();
}

// hd 64, 96, 128 and 256 run with every bound constant; any other
// multiple of 8 runs padded in the next instantiation up.
cudaError_t dispatch_tf32(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int Sq, int Sk, int hd,
                          float scale, int causal, int window, int sk_pad,
                          cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_tf32<64, TF_BK, true, false>(q, k, v, o, B, H, Sq, Sk, hd,
                                                 scale, causal, window, sk_pad, s);
    case 96:
      return launch_tf32<96, TF_BK_WIDE, false, false>(
          q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
    case 128:
      return launch_tf32<128, TF_BK_WIDE, false, false>(
          q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
    case 256:
      return launch_tf32<256, TF_BK_WIDE, false, false>(
          q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
  }
  if (hd < 64)
    return launch_tf32<64, TF_BK, true, true>(q, k, v, o, B, H, Sq, Sk, hd,
                                              scale, causal, window, sk_pad, s);
  if (hd < 128)
    return launch_tf32<128, TF_BK_WIDE, false, true>(
        q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
  return launch_tf32<256, TF_BK_WIDE, false, true>(
      q, k, v, o, B, H, Sq, Sk, hd, scale, causal, window, sk_pad, s);
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
  return (int)dispatch_tf32(q, k, v, o, B, H, Sq, Sk, hd, scale, causal,
                            window, sk_pad, s);
}

}  // extern "C"
