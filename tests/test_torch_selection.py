"""The port's draws without replacement and the paper's baseline schemes
against the JAX package: ``rng.permutation`` and ``rng.choice(...,
replace=False)`` bit for bit (one and two shuffle rounds, tied 32-bit
keys), the per-cluster random sampler against its loop oracle and JAX
(tied uniform noise at N = 200,000), and ``select_round`` under each of
the four schemes (winners, s_min and bids bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core import rounds as JR
from repro.core import selection as JS
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import selection as TS

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

SCHEMES = ("gradient_cluster_auction", "gradient_cluster_random",
           "weights_cluster_random", "random")


def _torch_state(js):
    return interop.selection_state_from_numpy(
        np.asarray(js.clusters), np.asarray(js.residual),
        np.asarray(js.history), np.asarray(js.local_sizes), device="cpu")


def _fleet(n, j, seed, **kw):
    cfg = dict(num_clients=n, num_clusters=j, select_ratio=0.1,
               init_energy_mode="normal", **kw)
    js = JR.synthetic_fleet(JConfig(**cfg), jax.random.PRNGKey(seed))
    return JConfig(**cfg), FLConfig(**cfg), js, _torch_state(js)


# ----------------------------------------------------------------------
# permutation and choice without replacement
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 2000, 200_000])
@pytest.mark.parametrize("seed", [0, 7])
def test_permutation_bit_identical(n, seed):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = rng.permutation(rng.PRNGKey(seed), n, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(1, 1), (100, 10), (2000, 200),
                                 (200_000, 20_000)])
def test_choice_without_replacement_bit_identical(n, k):
    for seed in (1, 2):
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                            (k,), replace=False))
        got = rng.choice(rng.PRNGKey(seed), n, (k,), replace=False,
                         device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert len(set(got.tolist())) == k


def test_shuffle_rounds_and_tied_keys():
    """n = 2000 takes two shuffle rounds (one up to n = 1625), and at
    n = 200,000 some 32-bit keys of a round tie: a stable sort keeps
    them in order, as lax.sort_key_val does."""
    assert np.ceil(3 * np.log(1625) / np.log(2 ** 32 - 1)) == 1
    assert np.ceil(3 * np.log(2000) / np.log(2 ** 32 - 1)) == 2
    _, sub = rng.split(rng.PRNGKey(0))
    b = rng.bits(sub, (200_000,), "cpu")
    assert len(torch.unique(b)) < 200_000


@pytest.mark.parametrize("n", [1, 16, 17, 100, 4097, 1_000_000])
def test_cumsum_sums_in_xla_order(n):
    """``rng.cumsum`` rounds as jnp.cumsum does on the CPU (blocks of 16),
    which ``choice``'s pick depends on at large N."""
    r = np.random.default_rng(n)
    x = (r.random(n) * (r.random(n) > 0.5)).astype(np.float32)
    np.testing.assert_array_equal(rng.cumsum(torch.tensor(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_choice_refuses_oversized_sample():
    with pytest.raises(ValueError, match="larger sample"):
        rng.choice(rng.PRNGKey(0), 5, (6,), replace=False, device="cpu")


# ----------------------------------------------------------------------
# the per-cluster random sampler
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,j,seed", [(60, 5, 0), (500, 7, 1),
                                      (3000, 10, 2), (200_000, 10, 3)])
def test_random_per_cluster_matches_loop_and_jax(n, j, seed):
    jcfg, tcfg, js, ts = _fleet(n, j, seed)
    elig = np.random.default_rng(seed).random(n) > 0.4
    if n == 60:
        elig[np.asarray(js.clusters) == 2] = False   # a cluster relaxes
    key_j, key_t = jax.random.PRNGKey(seed + 10), rng.PRNGKey(seed + 10)
    want = np.asarray(JS._random_per_cluster(key_j, js, jcfg,
                                             jnp.asarray(elig)))
    got = TS._random_per_cluster(key_t, ts, tcfg, torch.tensor(elig))
    oracle = TS._random_per_cluster_loop(key_t, ts, tcfg,
                                         torch.tensor(elig))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(oracle.numpy(), want)
    if n == 200_000:      # the float32 noise ties inside clusters here
        noise = rng.uniform(key_t, (n,), device="cpu")
        assert len(torch.unique(noise)) < n
    if n <= 3000:
        np.testing.assert_array_equal(
            np.asarray(JS._random_per_cluster_loop(key_j, js, jcfg,
                                                   jnp.asarray(elig))),
            want)


# ----------------------------------------------------------------------
# select_round under each scheme
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_round_bit_identical(scheme, seed):
    jcfg, tcfg, js, ts = _fleet(300, 7, seed, scheme=scheme)
    avail = np.random.default_rng(seed).random(300) > 0.2
    for a_j, a_t in ((None, None), (jnp.asarray(avail), torch.tensor(avail))):
        jw, ji = JS.select_round(js, jcfg, jax.random.PRNGKey(seed + 5),
                                 avail=a_j)
        tw, ti = TS.select_round(ts, tcfg, rng.PRNGKey(seed + 5),
                                 avail=a_t)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert sorted(ti) == sorted(ji)
        if "s_min" in ji:
            assert int(ti["s_min"]) == int(ji["s_min"])
        np.testing.assert_allclose(ti["bids"].numpy(),
                                   np.asarray(ji["bids"]), rtol=1e-6)
        assert int(tw.sum()) > 0


def test_random_scheme_draws_blind_and_exactly_k():
    """The pure random baseline picks round(select_ratio * N) clients
    without looking at availability or clusters."""
    jcfg, tcfg, js, ts = _fleet(300, 7, 4, scheme="random")
    none = torch.zeros(300, dtype=torch.bool)
    tw, _ = TS.select_round(ts, tcfg, rng.PRNGKey(9), avail=none)
    assert int(tw.sum()) == 30
    jw, _ = JS.select_round(js, jcfg, jax.random.PRNGKey(9))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("n", [200_000, 1_000_000])
def test_sample_threshold_random_member_at_scale(n):
    """At fleet scale the member pick rides a 1e-6-wide step of the
    cumulative probabilities: held to JAX's compiled round."""
    jcfg, tcfg, js, ts = _fleet(n, 10, 5, scheme="gradient_cluster_random")
    thr = jax.jit(JS._sample_threshold, static_argnums=(2, 3))
    for k in range(4):
        want = int(thr(jax.random.PRNGKey(k), js, jcfg, None))
        assert int(TS._sample_threshold(rng.PRNGKey(k), ts, tcfg,
                                        None)) == want


def test_sample_threshold_random_member_matches_jax():
    """The random schemes' s_min is one random member's size of the
    probe cluster (0 when the probe cluster is empty)."""
    for seed in range(6):
        jcfg, tcfg, js, ts = _fleet(80, 6, seed,
                                    scheme="gradient_cluster_random")
        cl = np.asarray(js.clusters).copy()
        cl[cl == 3] = 0              # cluster 3 empty
        js.clusters, ts.clusters = jnp.asarray(cl), torch.tensor(cl)
        for k in range(5):
            want = int(JS._sample_threshold(jax.random.PRNGKey(k), js, jcfg,
                                            None))
            got = int(TS._sample_threshold(rng.PRNGKey(k), ts, tcfg, None))
            assert got == want
