"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

A torch port of the threefry2x32 generator in JAX's *partitionable* mode
(``jax_threefry_partitionable=True``, the default since JAX 0.5): the
counter of element ``i`` of a draw of shape ``s`` is the 64-bit flat index
``i`` split into (hi, lo) uint32 halves, and one threefry2x32 call hashes
the pair.  ``split``/``fold_in`` derive keys the same way, so a seeded run
of the port walks the same key chain as the JAX package and draws the same
integers: the s_min probe cluster, the stage-1 sample windows and the
k-means++ first pick.

A key is a CPU ``int64`` tensor of shape (2,) holding two uint32 words
(torch has too few uint32 ops, so every word lives in int64 and is masked
with ``& 0xFFFFFFFF``).  Draws take an explicit ``device``; the key chain
itself stays on the host.  As everywhere in the port, ``device`` defaults
to ``"cuda"`` and raises without a GPU.

Float draws follow ``jax/_src/random.py`` operation for operation
(mantissa bits OR'd into 1.0, then ``- 1``, ``* (max - min) + min``,
``max(min, .)``); ``normal`` goes through XLA's single-precision erfinv
polynomial so the values agree to a few ulps.  Where XLA fuses a multiply
and an add into one FMA, the port rounds once too (``_fma``), so
``uniform`` is bit-identical.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device
_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s)
                                                              for s in shape)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; all words are uint32 values in int64 tensors."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for step in range(5):
        for r in _ROT[step % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(step + 1) % 3]) & _MASK
        b = (b + ks[(step + 2) % 3] + step + 1) & _MASK
    return a, b


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU backend fuses
    it (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _key_words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    return int(k[0]), int(k[1])


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(hi, lo) uint32 halves of the flat 64-bit iota over ``shape``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey``: the seed's high and low 32-bit words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("PRNGKey takes a non-negative seed")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, key ``i`` = hash of counter i."""
    k1, k2 = _key_words(key)
    hi, lo = _counters((int(num),), key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash of the counter pair (0, data)."""
    k1, k2 = _key_words(key)
    d = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    a, b = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.cat([a, b])


def bits(key: torch.Tensor, shape: Shape = (), device="cuda") -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: uint32 values as an int64 tensor."""
    device = resolve_device(device)
    shape = _shape(shape)
    k1, k2 = _key_words(key)
    hi, lo = _counters(shape, device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def randint(key: torch.Tensor, shape: Shape, minval, maxval,
            device="cuda") -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws (from the halves
    of ``split(key)``) folded into [minval, maxval) by the same modular
    arithmetic, uint32 wrap-around included.  Returns int64."""
    device = resolve_device(device)
    shape = _shape(shape)
    kh, kl = split(key)
    higher = bits(kh, shape, device)
    lower = bits(kl, shape, device)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    mult = (65536 % span)
    mult = ((mult * mult) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + (lower % span)
    off = (off & _MASK) % span
    return lo + off


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0,
            device="cuda") -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    device = resolve_device(device)
    shape = _shape(shape)
    b = bits(key, shape, device)
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's single-precision erfinv (M. Giles, "Approximating the erfinv
# function"), the polynomial jax.lax.erf_inv lowers to for float32
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv through XLA's polynomial (matches jax.lax.erf_inv to
    a few ulps; ``torch.erfinv`` is a different approximation)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], device=x.device),
                    torch.tensor(_ERFINV_GE5[0], device=x.device))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.tensor(c_lt, device=x.device),
                        torch.tensor(c_ge, device=x.device))
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)


def normal(key: torch.Tensor, shape: Shape = (), device="cuda"
           ) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(uniform(-1+, 1))."""
    device = resolve_device(device)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, lo, 1.0, device)
    return _SQRT2.to(device) * erfinv(u)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape = (), device="cuda") -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32, clamped to the open
    interval (lower, upper)."""
    device = resolve_device(device)
    sqrt2 = _SQRT2.to(device)
    lo = torch.tensor(lower, dtype=torch.float32, device=device)
    hi = torch.tensor(upper, dtype=torch.float32, device=device)
    a = torch.erf(lo / sqrt2)
    b = torch.erf(hi / sqrt2)
    out = sqrt2 * erfinv(uniform(key, shape, a, b, device))
    inf = torch.tensor(math.inf, device=device)
    return torch.clamp(out, torch.nextafter(lo, inf),
                       torch.nextafter(hi, -inf))


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)`` for one draw with replacement:
    ``r = cumsum(p)[-1] * (1 - u)``, then ``searchsorted`` (left).
    Returns a 0-d int64 tensor on ``p``'s device."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    p_cuml = torch.cumsum(p.to(torch.float32), 0)
    r = p_cuml[-1] * (1.0 - uniform(key, (), device=p.device))
    return torch.searchsorted(p_cuml, r.reshape(1)).reshape(())
