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
``max(min, .)``); ``normal`` and ``truncated_normal`` go through XLA's
single-precision erfinv polynomial and its ``log1p`` (``xla_math``), so
they are bit-identical too.  Where XLA fuses a multiply and an add into
one FMA, the port rounds once too (``_fma``, ``xla_math.fma``), so
``uniform`` is bit-identical.  ``permutation`` and ``choice`` without
replacement run JAX's sort-based shuffle: rounds of fresh 32-bit keys,
each a stable sort.

A draw copies nothing from the host to its device: bounds given as
Python numbers stay Python numbers (rounded to float32 on the host where
JAX rounds them), so the selection-only round loop
(``core/rounds.simulate_rounds``) runs with no host synchronisation.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import xla_math
from repro_torch.device import resolve_device
_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s)
                                                              for s in shape)


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; all words are uint32 values in int64 tensors."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    # fresh full-shape words, then every step in place (the hash is a
    # hundred elementwise ops; allocating each was most of its time)
    a, b = torch.broadcast_tensors((x1 + ks[0]) & _MASK,
                                   (x2 + ks[1]) & _MASK)
    a, b = a.contiguous(), b.contiguous()
    t = torch.empty_like(b)
    for step in range(5):
        for r in _ROT[step % 2]:
            a.add_(b).bitwise_and_(_MASK)
            torch.bitwise_left_shift(b, r, out=t)       # b = rotl(b) ^ a
            b.bitwise_right_shift_(32 - r).bitwise_or_(t)
            b.bitwise_and_(_MASK).bitwise_xor_(a)
        a.add_(ks[(step + 1) % 3]).bitwise_and_(_MASK)
        b.add_(ks[(step + 2) % 3] + step + 1).bitwise_and_(_MASK)
    return a, b


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU backend fuses
    it (the float32 product is exact in float64); ``b`` and ``c`` may be
    Python floats that hold float32 values.  The float64 sum is exact,
    so nothing is rounded twice, where the operands' bits span at most
    53 places, as the uniform's mantissa times its width plus its lower
    bound do; ``xla_math.fma`` rounds once for any float32 operands."""
    return (a.double() * _f64(b) + _f64(c)).float()


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


def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in(keys[m], data[m])`` for every row m at once: ``keys``
    (M, 2) (or one (2,) key for every row), ``data`` (M,) int64; returns
    (M, 2) keys on ``data``'s device, bit-identical to the one-key
    :func:`fold_in`."""
    keys = keys.to(data.device).reshape(-1, 2)
    d = data.to(torch.int64) & _MASK
    a, b = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


# flat elements per piece of a large draw: cache-sized on the CPU, and
# on the card small enough that the hash's int64 words and the float64
# erfinv of a multi-GB weight stay a few hundred MB (see _by_pieces)
_PIECE = {"cpu": 1 << 16, "cuda": 1 << 24}


def _by_pieces(n: int, device: torch.device, fn) -> torch.Tensor:
    """``fn(start, stop)`` over the flat range [0, n), written piece by
    piece into one (n,) tensor.  On the CPU the pieces are
    cache-sized: the hash is a hundred in-place passes, which over a whole
    multi-MB tensor are bound by memory (2.5x slower for a (4096, 256)
    slab).  On the card they bound the temporaries: a draw of 940 M
    elements would otherwise hold several 7.5 GB int64 words at once.
    Elementwise in the flat counter, so the values are the same either
    way."""
    piece = _PIECE.get(device.type, _PIECE["cuda"])
    first = fn(0, min(piece, n))
    if n <= piece:
        return first
    out = torch.empty((n,), dtype=first.dtype, device=device)
    out[:piece] = first
    for s in range(piece, n, piece):
        out[s:min(s + piece, n)] = fn(s, min(s + piece, n))
    return out


def _bits_flat(k1: int, k2: int, start: int, stop: int, device
               ) -> torch.Tensor:
    """The 32-bit draws of flat counters [start, stop)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    a, b = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return a ^ b


def bits(key: torch.Tensor, shape: Shape = (), device="cuda") -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: uint32 values as an int64 tensor."""
    device = resolve_device(device)
    shape = _shape(shape)
    k1, k2 = _key_words(key)
    return _by_pieces(math.prod(shape), device, lambda s, e: _bits_flat(
        k1, k2, s, e, device)).reshape(shape)


def _fold_range(higher: torch.Tensor, lower: torch.Tensor, lo, hi
                ) -> torch.Tensor:
    """``jax.random.randint``'s fold of two 32-bit draws into [lo, hi),
    uint32 wrap-around included; ``lo``/``hi`` are ints or int64 tensors
    that broadcast against the draws."""
    if isinstance(lo, int) and isinstance(hi, int):
        span = 1 if hi <= lo else (hi - lo) & _MASK
    else:
        span = torch.where(hi <= lo, torch.ones_like(hi - lo),
                           (hi - lo) & _MASK)
    mult = (65536 % span)
    mult = ((mult * mult) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + (lower % span)
    off = (off & _MASK) % span
    return lo + off


def _int_bound(v, device):
    """A randint bound: a Python int stays one, a tensor moves to the
    draw's device as int64."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return int(v)


def _float_bound(v, device):
    """A uniform bound as JAX takes it: a Python number rounded to
    float32 (kept a Python float), a tensor as float32 on the device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return float(np.float32(v))


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
    return _fold_range(higher, lower, _int_bound(minval, device),
                       _int_bound(maxval, device))


def randint_rows(keys: torch.Tensor, n: int, minval: int,
                 maxval: torch.Tensor) -> torch.Tensor:
    """``randint(keys[m], (n,), minval, maxval[m])`` for every row m at
    once: ``keys`` (M, 2) and ``maxval`` (M,) on one device; returns
    (M, n) int64, bit-identical to the one-key :func:`randint`."""
    k1, k2 = keys[:, :1], keys[:, 1:]
    zero = torch.zeros((1, 2), dtype=torch.int64, device=keys.device)
    # split(keys[m]): key j of row m is (w1[m, j], w2[m, j])
    w1, w2 = threefry2x32(k1, k2, zero, zero + torch.arange(
        2, device=keys.device))
    hi, lo = _counters((n,), keys.device)
    draws = [a ^ b for a, b in (
        threefry2x32(w1[:, j:j + 1], w2[:, j:j + 1], hi[None], lo[None])
        for j in (0, 1))]
    return _fold_range(draws[0], draws[1],
                       torch.full_like(draws[0][:, :1], int(minval)),
                       maxval.to(torch.int64)[:, None])


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0,
            device="cuda") -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    device = resolve_device(device)
    return _uniform_from_bits(bits(key, shape, device), minval, maxval,
                              device)


def _uniform_from_bits(b: torch.Tensor, minval, maxval, device
                       ) -> torch.Tensor:
    """32-bit draws -> float32 uniforms in [minval, maxval), as JAX maps
    them."""
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo, hi = _float_bound(minval, device), _float_bound(maxval, device)
    if isinstance(lo, float) and isinstance(hi, float):
        width = float(np.float32(hi) - np.float32(lo))   # float32, as JAX
        return torch.clamp(_fma(floats, width, lo), min=lo)
    return torch.clamp(_fma(floats, hi - lo, lo), min=lo)


def bernoulli(key: torch.Tensor, p: float, shape: Shape = (),
              device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) <
    p`` with ``p`` rounded to float32, as JAX compares it.  p = 0 draws
    no True, p = 1 all True (the uniform lies in [0, 1))."""
    return uniform(key, shape, device=device) < float(np.float32(p))


# XLA's single-precision erfinv (M. Giles, "Approximating the erfinv
# function"), the polynomial jax.lax.erf_inv lowers to for float32
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv through XLA's polynomial, bit for bit as
    ``jax.lax.erf_inv`` on the CPU (``torch.erfinv`` is a different
    approximation): XLA's own ``log1p`` and single-rounding FMAs
    (``xla_math``), and a correctly rounded ``sqrt`` (torch's vectorised
    CPU ``sqrt`` is off by an ulp on some inputs); denormals flushed to
    zero, as XLA flushes them."""
    x = xla_math.flush(x)
    w = -xla_math.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = torch.tensor([_ERFINV_GE5, _ERFINV_LT5], dtype=torch.float32,
                        device=x.device)[lt.long()]           # (..., 9)
    p = coef[..., 0]
    for i in range(1, coef.shape[-1]):
        p = xla_math.fma(p, w, coef[..., i])
    return torch.where(x.abs() == 1.0, x * math.inf,
                       xla_math.flush(p * x))


_SQRT2 = float(np.float32(math.sqrt(2.0)))

# A float32 uniform takes one of 2^23 values (the 23 mantissa bits of its
# draw), so a normal or truncated-normal draw does too.  A draw of at
# least _TABLE_MIN elements reads its values from a table of all 2^23
# (32 MB, built once per device and bounds by the same functions as a
# small draw, so the values are the same): the exact erfinv costs a few
# hundred elementwise passes, a table read one.
_TABLE_MIN = 1 << 16
_TABLES: dict = {}


def _from_bits(k1: int, k2: int, n: int, device, values, table_key
               ) -> torch.Tensor:
    """``values(bits)`` over the n flat counters of key (k1, k2), read
    from the table of ``values`` over every mantissa (cached under
    ``table_key``) when n >= _TABLE_MIN."""
    if device.type == "meta":   # shapes without values (launch.specs)
        return torch.empty((n,), dtype=torch.float32, device=device)
    if n < _TABLE_MIN:
        return _by_pieces(n, device, lambda s, e: values(
            _bits_flat(k1, k2, s, e, device)))
    key = (table_key, str(device))
    table = _TABLES.get(key)
    if table is None:
        table = _by_pieces(1 << 23, device, lambda s, e: values(
            torch.arange(s, e, dtype=torch.int64, device=device) << 9))
        _TABLES[key] = table
    return _by_pieces(n, device, lambda s, e: table[
        _bits_flat(k1, k2, s, e, device) >> 9])


def normal(key: torch.Tensor, shape: Shape = (), device="cuda"
           ) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(uniform(-1+, 1))."""
    device = resolve_device(device)
    shape = _shape(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    k1, k2 = _key_words(key)
    return _from_bits(k1, k2, math.prod(shape), device, lambda b: _SQRT2 * erfinv(
        _uniform_from_bits(b, lo, 1.0, device)), ("normal",)).reshape(shape)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape = (), device="cuda") -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32, clamped to the open
    interval (lower, upper).  The uniform's bounds erf(lower / sqrt 2)
    and erf(upper / sqrt 2) are taken on the CPU, so every device draws
    the same values."""
    device = resolve_device(device)
    shape = _shape(shape)
    f32 = dict(dtype=torch.float32)
    sqrt2 = torch.tensor(_SQRT2, **f32)
    lo = torch.tensor(lower, **f32)
    hi = torch.tensor(upper, **f32)
    a = torch.erf(lo / sqrt2).item()
    b = torch.erf(hi / sqrt2).item()
    lo_open = torch.nextafter(lo, torch.tensor(math.inf)).item()
    hi_open = torch.nextafter(hi, torch.tensor(-math.inf)).item()
    k1, k2 = _key_words(key)

    def values(bits):
        u = _uniform_from_bits(bits, a, b, device)
        return torch.clamp(_SQRT2 * erfinv(u), lo_open, hi_open)

    return _from_bits(k1, k2, math.prod(shape), device, values,
                      ("truncated_normal", lower, upper)).reshape(shape)


_SCAN_BLOCK = 16


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Float cumulative sum along the last axis in the order XLA's CPU
    backend sums ``jnp.cumsum``: blocks of 16 each summed in order, the
    block totals scanned the same way, and each block's exclusive prefix
    added.  ``torch.cumsum`` rounds in another order on the CPU and in a
    timing-dependent one on CUDA, which moves ``choice``'s pick at large
    N; this one is bit-identical on both and run to run.  Out of place,
    so it runs under ``torch.func`` transforms."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n <= _SCAN_BLOCK:
        blocks = x.reshape(*lead, 1, n)
    else:
        nb = -(-n // _SCAN_BLOCK)
        blocks = torch.nn.functional.pad(
            x, (0, nb * _SCAN_BLOCK - n)).reshape(*lead, nb, _SCAN_BLOCK)
    cols = [blocks[..., 0]]
    for j in range(1, blocks.shape[-1]):
        cols.append(cols[-1] + blocks[..., j])
    inner = torch.stack(cols, dim=-1)
    if n <= _SCAN_BLOCK:
        return inner.reshape(*lead, n)
    outer = cumsum(inner[..., -1])
    before = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                       dim=-1)
    return (inner + before[..., None]).reshape(*lead, -1)[..., :n]


def permutation(key: torch.Tensor, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` through JAX's
    sort shuffle.  ``ceil(3 ln(max(1, n)) / ln(2^32 - 1))`` rounds (one up
    to n = 1,625; two up to about 2.6e9); each round splits a fresh
    subkey, draws 32-bit keys and sorts by them stably
    (``lax.sort_key_val`` is stable), so tied keys keep their order as in
    JAX.  Returns int64 on ``device``."""
    device = resolve_device(device)
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (),
           replace: bool = True, p: torch.Tensor = None,
           device="cuda") -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace, p)`` over ``arange(n)``:
    without ``p`` and without replacement ``permutation(key, n)[:k]``;
    with ``p`` and replacement ``r = cumsum(p)[-1] * (1 - u)`` (the
    :func:`cumsum` of XLA's order), then ``searchsorted`` (left).
    Returns int64 on ``p``'s device (``device`` is then unused), else on
    ``device``.  Without ``p`` replacement draws are ``randint``; with
    ``p`` only replacement draws are ported (JAX's Gumbel top-k path for
    ``replace=False`` has no caller here)."""
    shape = _shape(shape)
    k = math.prod(shape)
    if p is None:
        device = resolve_device(device)
        if replace:
            return randint(key, shape, 0, n, device)
        if k > n:
            raise ValueError(f"Cannot take a larger sample (size {k}) than "
                             f"population (size {n}) when 'replace=False'")
        return permutation(key, n, device)[:k].reshape(shape)
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    if not replace:
        raise NotImplementedError(
            "choice with p and replace=False (JAX's Gumbel top-k) has no "
            "caller in the port")
    p_cuml = cumsum(p.to(torch.float32))
    r = p_cuml[-1] * (1.0 - uniform(key, shape, device=p.device))
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(shape)
