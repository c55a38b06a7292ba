"""XLA's CPU float32 ``log1p`` and ``log``, operation for operation.

The JAX package's float32 draws and inits go through ``jnp.log1p`` (in
``jax.lax.erf_inv``, so every ``normal`` and ``truncated_normal``) and
``jnp.log`` (Mamba's ``a_log``).  XLA's CPU backend inlines both as
float32 multiplies, adds and selects; torch's ``log1p`` and ``log``
round otherwise in a few percent of the elements.  These functions redo
XLA's sequence of float32 operations in torch, each rounded as XLA
rounds it, so they give XLA's bits.  Read the sequence from the LLVM IR
that ``XLA_FLAGS=--xla_dump_to=DIR`` writes for ``jax.jit(jnp.log1p)``
on the CPU (``*.wrapped_log-plus-one_kernel_module.ir-with-opt.ll``;
``jnp.log`` dumps alike):

* ``log(a)``: a is clamped below at the smallest normal number, split by
  bit operations into a mantissa m in [0.5, 1) and an exponent e; below
  sqrt(1/2) the mantissa is doubled (as (m - 1) + m) and e lowered by
  one; then Cephes' ``logf`` polynomial in x = m - 1, evaluated as three
  interleaved chains over x^3, and e * ln 2 in two parts.  Zero gives
  -inf, +inf gives +inf, a negative or NaN input NaN.
* ``log1p(x)``: for |x| < sqrt(2) - 1 a rational function of x (degree 6
  over 6, Horner in float32, one division), x - x^2 / 2 + x^3 * P / Q;
  else ``log(1 + x)`` as above.

The IR carries no ``fma`` and no ``contract`` flag, but XLA's CPU
backend compiles it with floating-point fusion allowed, so the machine
code (``objdump -d`` of the dumped ``*.o``) fuses a multiply into the
add that uses it wherever the multiply has that one use: every Horner
step, the three chains and their joins, x - z / 2 and the e * ln 2
terms.  :func:`fma` rounds each such pair once; the remaining multiplies,
adds and the division are float32 torch ops, correctly rounded on the
CPU and on the card alike.  This holds on an x86 host with FMA (AVX2 or
AVX-512), where XLA emits these instructions.

XLA runs on the CPU with denormals flushed to zero, inputs and outputs,
so these functions flush a subnormal input (keeping its sign) and a
subnormal result.
"""
from __future__ import annotations

import math
import struct

import torch


def _f32(bits: int) -> float:
    """The float32 value with these IEEE bits, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _hex64(s: str) -> float:
    """A constant as the LLVM IR prints it: a double's bits that hold a
    float32 value."""
    return struct.unpack("<d", struct.pack("<Q", int(s, 16)))[0]


FLT_MIN = _f32(0x00800000)
SQRT_HALF = _hex64("3FE6A09E60000000")          # 0.70710677f
LOG1P_SMALL = _hex64("3FDA8279A0000000")        # sqrt(2) - 1, as float32

# Cephes logf: the three chains' (multiplier, addend) pairs and the
# addends that join them over x^3
_LOG_C = [_hex64(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000",     # chain A: x * c0 + c1
    "BFBFCBA9E0000000", "3FC23D37E0000000",     # chain B: x * c2 + c3
    "3FC999D580000000", "BFCFFFFF80000000",     # chain C: x * c4 + c5
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
_LN2_LO = _hex64("BF2BD01060000000")            # -2.12194440e-4
_LN2_HI = _hex64("3FE6300000000000")            # 0.693359375

# log1p's rational function for small |x|: denominator and numerator
# addends, each step (prev * x + c)
_L1P_DEN = [_hex64(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_L1P_NUM0 = _hex64("3F07BC0960000000")
_L1P_NUM = [_hex64(h) for h in (
    "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
    "404E798EC0000000", "404C8E75A0000000", "40340A2020000000")]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (a a float32 tensor, b and c float32
    tensors or Python floats that hold float32 values).  The product is
    exact in float64 and TwoSum gives the float64 sum t and its exact
    error.  Rounding t to float32 errs only where t lands on a float32
    midpoint that the exact sum misses; such a t has an even float64
    mantissa, and stepping an even t one float64 place toward the exact
    sum (round to odd) keeps every other t's float32 rounding and fixes
    that one.  Arithmetic only: no select, so no host synchronisation on
    the card."""
    s = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else c
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    bits = t.view(torch.int64)
    step = torch.sign(err * t).to(torch.int64) * (1 - (bits & 1))
    return (bits + step).view(torch.float64).float()


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values to zero of the same sign (XLA's denormal mode)."""
    return x * (x.abs() >= FLT_MIN)


def _log_normal(a: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of a, without the special cases (zero, inf,
    negative and NaN inputs give what the callers replace)."""
    bits = torch.clamp(a, min=FLT_MIN).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = (m < SQRT_HALF).float()
    x = (m + -1.0) + m * small
    e1 = (e.float() + 1.0) - small
    z = x * x
    x3 = z * x
    c = _LOG_C
    ya = fma(x, fma(x, c[0], c[1]), c[6])
    yb = fma(x, fma(x, c[2], c[3]), c[7])
    yc = fma(x, fma(x, c[4], c[5]), c[8])
    y = fma(x3, fma(x3, fma(x3, ya, yb), yc), e1 * _LN2_LO)
    r = fma(z, -0.5, x) + y
    return fma(e1, _LN2_HI, r)


def _log_special(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """r where a is positive and finite; -inf at 0, inf at inf, NaN for a
    negative or NaN a."""
    r = r.masked_fill(~(a > 0), math.nan)
    r = r.masked_fill(a == 0, -math.inf)
    return r.masked_fill(a == math.inf, math.inf)


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on a float32 tensor, bit for bit as XLA's CPU backend."""
    x = flush(x.float())
    return flush(_log_special(x, _log_normal(x)))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` on a float32 tensor, bit for bit as XLA's CPU
    backend."""
    x = flush(x.float())
    a = x + 1.0
    big = _log_special(a, _log_normal(a))
    x2 = x * x
    zero = x * 0.0
    den = zero + 1.0
    for c in _L1P_DEN:
        den = fma(den, x, c)
    num = zero + _L1P_NUM0
    for c in _L1P_NUM:
        num = fma(num, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return flush(torch.where(x.abs() < LOG1P_SMALL, small, big))
