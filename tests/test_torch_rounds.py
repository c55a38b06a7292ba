"""The port's round control plane against repro.core.rounds: winner
masks, s_min and history bit for bit over 20 rounds, energy within 1e-6;
tie-heavy winner ranking; zero-winner rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core import auction as JA
from repro.core import energy as JE
from repro.core import rounds as JR
from repro.core import selection as JS
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import auction as TA
from repro_torch.core import energy as TE
from repro_torch.core import rounds as TR

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

N, J = 200, 5


def _hists(seed, n=N, c=10):
    labels = np.random.default_rng(seed).integers(0, c, (n, 40))
    ch = np.stack([np.bincount(l, minlength=c) for l in labels])
    gh = np.bincount(labels.ravel(), minlength=c) / labels.size
    return ch.astype(np.float32), gh


def _torch_state(js):
    return interop.selection_state_from_numpy(
        np.asarray(js.clusters), np.asarray(js.residual),
        np.asarray(js.history), np.asarray(js.local_sizes), device="cpu")


def test_flconfig_fields_and_defaults_match():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(FLConfig)}
    assert tf == jf


@pytest.mark.parametrize("mode", ["normal", "full"])
def test_init_energy_close(mode):
    kw = dict(num_clients=500, init_energy_mode=mode)
    want = np.asarray(JE.init_energy(JConfig(**kw), jax.random.PRNGKey(7)))
    got = TE.init_energy(FLConfig(**kw), rng.PRNGKey(7), "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["normal", "full"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_body_20_rounds_bit_identical(mode, seed):
    kw = dict(num_clients=N, num_clusters=J, select_ratio=0.1,
              init_energy_mode=mode, seed=seed)
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    js = JR.synthetic_fleet(jcfg, jax.random.PRNGKey(seed))
    ts = _torch_state(js)
    ch, gh = _hists(seed)
    jstep = JR.make_round_step(jcfg, ch, gh)
    tstep = TR.make_round_step(tcfg, ch, gh, device="cpu")
    jk, tk = jax.random.PRNGKey(seed + 100), rng.PRNGKey(seed + 100)
    for t in range(20):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        js, jw, jm = jstep(js, jsub)
        ts, tw, tm = tstep(ts, tsub)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw),
                                      err_msg=f"round {t}")
        assert int(tm["s_min"]) == int(jm["s_min"])
        np.testing.assert_array_equal(ts.history.numpy(),
                                      np.asarray(js.history))
        np.testing.assert_allclose(ts.residual.numpy(),
                                   np.asarray(js.residual),
                                   rtol=1e-6, atol=1e-6)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(tm["num_winners"]) > 0


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_tied_bids_rank_like_jax(seed):
    """Quantized bids and tie-breaks force exact ties at the K_j boundary:
    the stable-sort lexsort and the top-k order must pick JAX's winners,
    in both winner implementations and in select_lowest_bids."""
    r = np.random.default_rng(seed)
    n, nc, kj = 120, 5, 4
    clusters = r.integers(0, nc, n).astype(np.int32)
    bids = r.choice([0.1, 0.3, 0.3, 0.3, 0.5], n).astype(np.float32)
    elig = r.uniform(size=n) > 0.25
    tb = r.choice([0.0, 0.2, 0.2, 0.7], n).astype(np.float32)
    jb, jc, je, jt = map(jnp.asarray, (bids, clusters, elig, tb))
    tbids, tcl, tel, ttb = map(torch.tensor, (bids, clusters, elig, tb))
    for tie_j, tie_t in ((None, None), (jt, ttb)):
        for impl in ("segmented", "loop"):
            np.testing.assert_array_equal(
                TA.cluster_winners(tbids, tcl, tel, kj, nc, tie_t,
                                   impl=impl).numpy(),
                np.asarray(JA.cluster_winners(jb, jc, je, kj, nc, tie_j,
                                              impl=impl)))
        for k in (1, 7, 30):
            np.testing.assert_array_equal(
                TA.select_lowest_bids(tbids, tel, k, tie_t).numpy(),
                np.asarray(JA.select_lowest_bids(jb, je, k, tie_j)))


def test_equal_bids_full_energy_round_matches():
    """Every client at full energy with one shared local size bids exactly
    the same: the whole auction is decided by the tie rules."""
    kw = dict(num_clients=60, num_clusters=4, select_ratio=0.2,
              init_energy_mode="full")
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    clusters = np.arange(60, dtype=np.int32) % 4
    sizes = np.full(60, 300, np.int32)
    js = JS.SelectionState(clusters=jnp.asarray(clusters),
                           residual=jnp.full((60,), 100.0),
                           history=jnp.zeros(60, jnp.int32),
                           local_sizes=jnp.asarray(sizes))
    ts = _torch_state(js)
    jk, tk = jax.random.PRNGKey(3), rng.PRNGKey(3)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        js, jw, _ = JR.make_round_step(jcfg)(js, jsub)
        ts, tw, _ = TR.make_round_step(tcfg, device="cpu")(ts, tsub)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_zero_winner_round_pays_zero():
    """No client can afford the round: no winners, and both reward sides
    are exactly zero (no 0/0), in both reward models."""
    for model in ("bid_share", "sample_share"):
        kw = dict(num_clients=30, num_clusters=3, reward_model=model)
        jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
        js = JS.SelectionState(
            clusters=jnp.asarray(np.arange(30, dtype=np.int32) % 3),
            residual=jnp.zeros(30), history=jnp.zeros(30, jnp.int32),
            local_sizes=jnp.full((30,), 200, jnp.int32))
        ts = _torch_state(js)
        _, jw, jm = JR.make_round_step(jcfg)(js, jax.random.PRNGKey(0))
        _, tw, tm = TR.make_round_step(tcfg, device="cpu")(ts, rng.PRNGKey(0))
        assert not tw.any() and not np.asarray(jw).any()
        for k in ("client_reward_sum", "server_reward", "mean_bid"):
            assert float(tm[k]) == 0.0 == float(jm[k])


@pytest.mark.parametrize("profile", ["energy", "uniform", "lognormal",
                                     "none"])
def test_dynamics_round_step_raises(profile):
    """The dynamics round step (``make_round_step(dynamics=True)``)
    against the JAX package's over 8 rounds on shared keys: winners,
    outcome codes, next availability and staleness bit for bit, energy
    within 1e-6, every metric within 1e-5."""
    from repro.sim import dynamics as JDYN
    from repro_torch.sim import dynamics as TDYN
    kw = dict(num_clients=N, num_clusters=J, select_ratio=0.1, seed=4,
              churn=0.2, deadline=1.1, straggler_profile=profile)
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    js = JR.synthetic_fleet(jcfg, jax.random.PRNGKey(4))
    js = JS.SelectionState(clusters=js.clusters, residual=js.residual,
                           history=js.history, local_sizes=js.local_sizes,
                           staleness=jnp.zeros(N, jnp.int32))
    ts = _torch_state(js)
    ts.staleness = torch.zeros(N, dtype=torch.int32)
    jd, td = JDYN.init_dynamics(jcfg), TDYN.init_dynamics(tcfg, "cpu")
    ch, gh = _hists(4)
    jstep = JR.make_round_step(jcfg, ch, gh, dynamics=True)
    tstep = TR.make_round_step(tcfg, ch, gh, dynamics=True, device="cpu")
    jk, tk = jax.random.PRNGKey(9), rng.PRNGKey(9)
    jdk, tdk = JDYN.dynamics_key(jcfg), TDYN.dynamics_key(tcfg)
    np.testing.assert_array_equal(tdk.numpy(), np.asarray(jdk))
    for t in range(8):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        jdk, jdsub = jax.random.split(jdk)
        tdk, tdsub = rng.split(tdk)
        js, jd, jw, jo, jm = jstep(js, jd, jsub, jdsub)
        ts, td, tw, to, tm = tstep(ts, td, tsub, tdsub)
        for a, b in ((tw, jw), (to, jo), (td.avail, jd.avail),
                     (ts.staleness, js.staleness), (ts.history, js.history)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"round {t}")
        np.testing.assert_allclose(ts.residual.numpy(),
                                   np.asarray(js.residual),
                                   rtol=1e-6, atol=1e-6)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
