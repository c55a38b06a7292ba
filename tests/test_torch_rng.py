"""repro_torch.rng against jax.random: key ops and integer draws bit for
bit, float draws within stated bounds (partitionable threefry2x32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

SEEDS = [0, 3, 14, 1234, 2 ** 31 + 7]
SHAPES = [(), (7,), (3, 5), (1000,)]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_ops_bit_identical(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())
    for data in (0, 1, 77, 2 ** 32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(kj, data)),
                                      rng.fold_in(kt, data).numpy())
    # a chain: split, then fold_in, then split again
    a = jax.random.split(jax.random.fold_in(jax.random.split(kj)[1], 9))[0]
    b = rng.split(rng.fold_in(rng.split(kt)[1], 9))[0]
    np.testing.assert_array_equal(_np(a), b.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_randint_bit_identical(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
        rng.bits(kt, shape, device="cpu").numpy())
    for lo, hi in [(0, 10), (-2, 3), (0, 1), (5, 5), (0, 100_000),
                   (0, 2 ** 31 - 1)]:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(kj, shape, lo, hi)),
            rng.randint(kt, shape, lo, hi, "cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_row_draws_bit_identical(seed):
    """fold_in_rows and randint_rows (one key per row, the batched
    stage-1 window draws) against jax.random row by row."""
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    data = [0, 1, 77, 2 ** 32 - 1, 5]
    keys = rng.fold_in_rows(kt, torch.tensor(data))
    sizes = [1, 7, 50, 2 ** 31 - 1, 3]
    draws = rng.randint_rows(keys, 11, 0, torch.tensor(sizes))
    for m, (d, n) in enumerate(zip(data, sizes)):
        kjm = jax.random.fold_in(kj, d)
        np.testing.assert_array_equal(_np(kjm), keys[m].numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(kjm, (11,), 0, n)),
            draws[m].numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 0.3), (-2.0, 5.5)])
def test_uniform_identical(seed, lo, hi):
    got = rng.uniform(rng.PRNGKey(seed), (4096,), lo, hi,
                      "cpu").numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4096,),
                                         minval=lo, maxval=hi))
    assert got.dtype == np.float32
    # bit-identical here (XLA's fused multiply-add is reproduced); the
    # stated contract is within 1 ulp
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_close(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_allclose(rng.normal(kt, (20_000,), "cpu").numpy(),
                               np.asarray(jax.random.normal(kj, (20_000,))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        rng.truncated_normal(kt, -2.5, 2.5, (20_000,), "cpu").numpy(),
        np.asarray(jax.random.truncated_normal(kj, -2.5, 2.5, (20_000,))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_choice_with_p_same_index(seed):
    p = np.random.default_rng(seed).random(50).astype(np.float32)
    p[::7] = 0.0
    p /= p.sum()
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for f in range(25):
        want = int(jax.random.choice(jax.random.fold_in(kj, f), 50,
                                     p=jnp.asarray(p)))
        got = int(rng.choice(rng.fold_in(kt, f), 50, torch.tensor(p)))
        assert got == want
