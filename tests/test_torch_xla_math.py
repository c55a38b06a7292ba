"""``repro_torch.xla_math`` against XLA's CPU ``log1p`` and ``log``, and
the draws built on them (``rng.erfinv``, ``normal``,
``truncated_normal``) against ``jax.random``, all bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch import xla_math as XM

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

# inputs of each of the four kinds: 2^20 in all for each function
N = 1 << 18
EDGES = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-40,
                  -1e-40, 1.1754944e-38, -1.1754944e-38, 2.0e-38, 1e-20,
                  -1e-20, 0.41421357, -0.41421357, 0.4142135, -0.4142135,
                  np.nextafter(np.float32(-1.0), np.float32(0.0)),
                  np.nextafter(np.float32(1.0), np.float32(0.0)),
                  np.nextafter(np.float32(1.0), np.float32(2.0)),
                  3.4e38, -3.4e38, 0.5, 2.0, 7.0], np.float32)


def _inputs(kind):
    g = np.random.default_rng(list(("bits", "unit", "near1",
                                    "minus_sq")).index(kind))
    if kind == "bits":      # every float32 bit pattern alike
        x = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    elif kind == "unit":
        x = g.uniform(-1.0, 1.0, N).astype(np.float32)
    elif kind == "near1":
        x = (1.0 + g.uniform(-1e-3, 1e-3, N)).astype(np.float32)
    else:                   # erfinv's argument of log1p
        x = g.uniform(-1.0, 1.0, N).astype(np.float32)
        x = -(x * x)
    return np.concatenate([x, EDGES])


def _assert_bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    bad = np.nonzero(~same)[0]
    assert bad.size == 0, (bad.size, got[bad[:5]], want[bad[:5]])


@pytest.mark.parametrize("fn", ["log1p", "log"])
@pytest.mark.parametrize("kind", ["bits", "unit", "near1", "minus_sq"])
def test_matches_xla_bit_for_bit(fn, kind):
    """2^18 inputs of each kind (2^20 in all) plus the edges: subnormals
    (flushed, as XLA flushes them), signed zeros, +-1, values near 1 and
    sqrt(2) - 1, infinities and NaN."""
    x = _inputs(kind)
    want = np.asarray(jax.jit(getattr(jnp, fn))(x))
    _assert_bits_equal(getattr(XM, fn)(torch.from_numpy(x)).numpy(), want)


def test_fma_rounds_once_where_float64_rounds_twice():
    """a * b + c lands just below (or above) a float32 midpoint: its
    float64 rounding is the midpoint itself, which a second rounding to
    float32 takes to the even neighbour; the exact result is the nearer
    one, r."""
    g = np.random.default_rng(1)
    n = 20_000
    r = (g.uniform(1, 2, n) * 2.0 ** g.integers(-20, 20, n)).astype(
        np.float32)
    e = np.floor(np.log2(r.astype(np.float64)))
    sign = np.where(g.integers(0, 2, n) == 1, 1.0, -1.0)
    # a * b = +-2^(e-24) (1 - 2^-46): a hair short of half an ulp of r
    a = (2.0 ** (e - 24) * (1 + 2.0 ** -23)).astype(np.float32)
    b = (sign * (1 - 2.0 ** -23)).astype(np.float32)
    got = XM.fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, r)
    twice = (a.astype(np.float64) * b + r).astype(np.float32)
    assert (twice != r).sum() > n // 4     # the case tells the two apart


def test_erfinv_matches_lax_erf_inv_bit_for_bit():
    x = np.concatenate([_inputs("unit"), _inputs("bits"), np.array(
        [0.0, -0.0, 1.0, -1.0, 0.9999999, -0.9999999, 1e-30],
        np.float32)])
    _assert_bits_equal(rng.erfinv(torch.from_numpy(x)).numpy(),
                       np.asarray(jax.lax.erf_inv(x)))


def test_normal_table_holds_every_draw_of_jax():
    """A float32 normal takes one of 2^23 values; the port's table of
    them is JAX's, value for value, so every draw is."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    idx = np.arange(1 << 23, dtype=np.uint32)
    floats = ((idx | 0x3F800000).view(np.float32) - np.float32(1.0))
    u = np.asarray(jax.jit(lambda f: jnp.maximum(
        lo, f * (np.float32(1.0) - lo) + lo))(floats))
    want = np.asarray(jax.jit(
        lambda u: np.float32(np.sqrt(2)) * jax.lax.erf_inv(u))(u))
    # the table built by the port's first large draw
    key = rng.PRNGKey(5)
    draw = rng.normal(key, (rng._TABLE_MIN,), "cpu")
    table = rng._TABLES[("normal",), "cpu"]
    _assert_bits_equal(table.numpy(), want)
    _assert_bits_equal(draw.numpy(),
                       np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                                    (rng._TABLE_MIN,))))


def test_small_draws_compute_erfinv_directly():
    """A draw below the table's threshold computes erfinv directly, and
    gives JAX's values too (the table's route: the test above and
    tests/test_torch_rng.py)."""
    n = 1000
    assert n < rng._TABLE_MIN
    for seed in (0, 1):
        kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        _assert_bits_equal(rng.normal(kt, (n,), "cpu").numpy(),
                           np.asarray(jax.random.normal(kj, (n,))))
        _assert_bits_equal(
            rng.truncated_normal(kt, -2.0, 2.0, (n,), "cpu").numpy(),
            np.asarray(jax.random.truncated_normal(kj, -2.0, 2.0, (n,))))
