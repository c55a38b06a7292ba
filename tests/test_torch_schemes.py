"""The port's scheme zoo, latency model and selection-only simulation
against the JAX package: the registry, ``round_latency`` under each
straggler profile, FedCS feasibility and winners, the long-term ledger
(``spent``, ``queue``, ``paid``) over 10 rounds, ``simulate_rounds`` ≡
``simulate_rounds_reference`` and both against JAX's for every scheme at
tests/test_rounds.py's N = 60, T = 10, ``synthetic_fleet``'s integer
draws, the ``--mode selection`` CLI against the JAX CLI, and the
``--mode paper`` CLI under every ``--scheme`` and ``--scheme-select``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core import rounds as JR
from repro.core import schemes as JSCH
from repro.sim import dynamics as JD
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import rounds as TR
from repro_torch.core import schemes as TSCH
from repro_torch.core import selection as TS
from repro_torch.launch import train as TRAIN
from repro_torch.sim import dynamics as TD

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

# (cfg.scheme, cfg.scheme_select): the paper's four schemes under the
# paper control plane, and the registry's other three
CASES = [("gradient_cluster_auction", "paper"),
         ("gradient_cluster_random", "paper"),
         ("weights_cluster_random", "paper"), ("random", "paper"),
         ("gradient_cluster_auction", "random"),
         ("gradient_cluster_auction", "fedcs"),
         ("gradient_cluster_auction", "longterm_auction")]


def _cfgs(**kw):
    base = dict(num_clients=60, num_clusters=6, select_ratio=0.2,
                init_energy_mode="normal")
    base.update(kw)
    return JConfig(**base), FLConfig(**base)


def _fleets(jcfg, tcfg, seed=1):
    """The JAX fleet and the port's, the port's residual energy set to
    JAX's (a float draw that feeds the bids)."""
    js = JR.synthetic_fleet(jcfg, jax.random.PRNGKey(seed))
    ts = TR.synthetic_fleet(tcfg, rng.PRNGKey(seed), device="cpu")
    ts.residual = torch.tensor(np.asarray(js.residual))
    return js, ts


def _ledger(ss):
    return {k: getattr(ss, k).numpy() for k in ("spent", "queue", "paid")}


def test_registry_matches_jax():
    assert TSCH.scheme_names() == JSCH.scheme_names()
    assert TSCH.stateful_scheme_names() == JSCH.stateful_scheme_names() \
        == ("longterm_auction",)
    with pytest.raises(KeyError, match="registered schemes"):
        TSCH.get_scheme("nope")
    with pytest.raises(ValueError, match="already registered"):
        TSCH.register(TSCH.get_scheme("paper"))
    ss = TSCH.init_scheme_state(FLConfig(num_clients=7,
                                         scheme_select="longterm_auction"),
                                "cpu")
    assert ss.paid.shape == (7,) and float(ss.spent) == 0.0
    assert TSCH.init_scheme_state(FLConfig(), "cpu") is None


@pytest.mark.parametrize("profile", ["energy", "uniform", "lognormal",
                                     "none"])
def test_round_latency_matches_jax(profile):
    """Held to JAX's compiled latency (the round step runs under jit):
    bit for bit where XLA's and torch's float ops agree; ``lognormal``
    goes through exp, which differs by an ulp, so within 1e-6."""
    r = np.random.default_rng(0)
    res = (r.random(4000) * 100).astype(np.float32)
    res[:4] = [0.0, 100.0, 50.0, 12.5]
    sizes = r.integers(1, 1200, 4000).astype(np.int32)
    lat = jax.jit(JD.round_latency, static_argnums=0)
    want = np.asarray(lat(JConfig(straggler_profile=profile),
                          jax.random.PRNGKey(4), jnp.asarray(res),
                          jnp.asarray(sizes)))
    got = TD.round_latency(FLConfig(straggler_profile=profile),
                           rng.PRNGKey(4), torch.tensor(res),
                           torch.tensor(sizes)).numpy()
    if profile == "lognormal":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="straggler_profile"):
        TD.latency_scale(FLConfig(straggler_profile="bogus"),
                         rng.PRNGKey(0), torch.tensor(res))


@pytest.mark.parametrize("deadline", [0.8, 1.0, 1.5])
def test_fedcs_never_picks_infeasible_winner_and_matches_jax(deadline):
    jcfg, tcfg = _cfgs(scheme_select="fedcs", fedcs_deadline=deadline)
    js, ts = _fleets(jcfg, tcfg, seed=2)
    step = jax.jit(JSCH.fedcs_select, static_argnums=1)
    for s in range(5):
        jw, ji = step(js, jcfg, jax.random.PRNGKey(100 + s))
        tw, ti = TSCH.fedcs_select(ts, tcfg, rng.PRNGKey(100 + s))
        lat = ti["pred_latency"].numpy()
        assert (lat[tw.numpy()] <= TSCH.fedcs_deadline(tcfg)).all()
        np.testing.assert_array_equal(lat, np.asarray(ji["pred_latency"]))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert TSCH.fedcs_deadline(tcfg.replace(deadline=1.2)) == 1.2


def test_fedcs_loose_deadline_is_the_paper_auction():
    jcfg, tcfg = _cfgs(scheme_select="fedcs", fedcs_deadline=1e9)
    _, ts = _fleets(jcfg, tcfg, seed=4)
    win_loose, _ = TSCH.fedcs_select(ts, tcfg, rng.PRNGKey(21))
    win_paper, _ = TS.select_round(ts, tcfg, rng.PRNGKey(21))
    assert torch.equal(win_loose, win_paper)


@pytest.mark.parametrize("total_reward", [100.0, 20.0])
def test_longterm_ledger_matches_jax_over_10_rounds(total_reward):
    jcfg, tcfg = _cfgs(scheme_select="longterm_auction",
                       total_reward=total_reward, target_rounds=10)
    js, ts = _fleets(jcfg, tcfg)
    jstep, tstep = JR.make_round_step(jcfg), TR.make_round_step(tcfg,
                                                                device="cpu")
    jk, tk = jax.random.PRNGKey(7), rng.PRNGKey(7)
    for t in range(10):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rng.split(tk)
        js, jw, jm = jstep(js, jsub)
        ts, tw, tm = tstep(ts, tsub)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw),
                                      err_msg=f"round {t}")
        want = {k: np.asarray(getattr(js.scheme_state, k))
                for k in ("spent", "queue", "paid")}
        for k, v in _ledger(ts.scheme_state).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k}, round {t}")
        for k in ("budget_spent", "budget_remaining", "budget_queue"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert float(ts.scheme_state.queue) >= 0.0


def test_longterm_exhausted_budget_selects_no_one():
    jcfg, tcfg = _cfgs(scheme_select="longterm_auction", total_reward=1.0)
    _, ts = _fleets(jcfg, tcfg)
    ts = dataclasses.replace(ts, scheme_state=TSCH.LongTermState(
        spent=torch.tensor(1.5), queue=torch.tensor(0.0),
        paid=torch.zeros(60)))
    win, _ = TSCH.longterm_select(ts, tcfg, rng.PRNGKey(0))
    assert int(win.sum()) == 0
    # a huge backlog caps every bid out too
    ts = dataclasses.replace(ts, scheme_state=TSCH.LongTermState(
        spent=torch.tensor(0.0), queue=torch.tensor(1e6),
        paid=torch.zeros(60)))
    win, _ = TSCH.longterm_select(ts, tcfg.replace(total_reward=100.0),
                                  rng.PRNGKey(0))
    assert int(win.sum()) == 0


def test_longterm_without_state_raises():
    _, tcfg = _cfgs(scheme_select="longterm_auction")
    _, ts = _fleets(*_cfgs())                  # scheme_state None
    with pytest.raises(ValueError, match="needs scheme_state"):
        TSCH.longterm_select(ts, tcfg, rng.PRNGKey(0))
    with pytest.raises(ValueError, match="needs scheme_state"):
        TSCH.get_scheme("longterm_auction").update_state(
            ts, ts, tcfg, torch.zeros(60, dtype=torch.bool), {},
            torch.zeros(60))


@pytest.mark.parametrize("scheme,select", CASES)
def test_simulate_rounds_matches_reference_and_jax(scheme, select):
    jcfg, tcfg = _cfgs(scheme=scheme, scheme_select=select)
    js, ts = _fleets(jcfg, tcfg)
    T = 10
    jf, jm, jw = JR.simulate_rounds(js, jcfg, jax.random.PRNGKey(123), T,
                                    record_wins=True)
    tf, tm, tw = TR.simulate_rounds(ts, tcfg, rng.PRNGKey(123), T,
                                    record_wins=True)
    rf, rm, rw = TR.simulate_rounds_reference(ts, tcfg, rng.PRNGKey(123),
                                              T, record_wins=True)
    # the pair: bit-identical
    np.testing.assert_array_equal(tw.numpy(), rw)
    assert torch.equal(tf.residual, rf.residual)
    assert torch.equal(tf.history, rf.history)
    assert sorted(tm) == sorted(rm)
    for k in tm:
        np.testing.assert_array_equal(tm[k].numpy(), rm[k], err_msg=k)
    # against JAX: integers bit for bit, floats to float reassociation
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tf.history.numpy(), np.asarray(jf.history))
    np.testing.assert_allclose(tf.residual.numpy(), np.asarray(jf.residual),
                               rtol=1e-6, atol=1e-5)
    assert sorted(tm) == sorted(jm)
    for k in ("num_winners", "s_min"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    for k in tm:
        np.testing.assert_allclose(tm[k].double().numpy(),
                                   np.asarray(jm[k], np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert all(v.shape == (T,) for v in tm.values())
    assert int(tw.sum()) > 0
    if select == "longterm_auction":
        want = {k: np.asarray(getattr(jf.scheme_state, k))
                for k in ("spent", "queue", "paid")}
        for k, v in _ledger(tf.scheme_state).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,mode", [(60, "normal"), (5000, "full"),
                                    (5000, "normal")])
def test_synthetic_fleet_integers_bit_identical(n, mode):
    kw = dict(num_clients=n, num_clusters=10, init_energy_mode=mode,
              scheme_select="longterm_auction")
    js = JR.synthetic_fleet(JConfig(**kw), jax.random.PRNGKey(3))
    ts = TR.synthetic_fleet(FLConfig(**kw), rng.PRNGKey(3), device="cpu")
    for f in ("clusters", "history", "local_sizes"):
        got = getattr(ts, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(js, f)))
    np.testing.assert_allclose(ts.residual.numpy(), np.asarray(js.residual),
                               rtol=1e-6, atol=1e-6)
    assert ts.scheme_state.paid.shape == (n,)


@pytest.mark.parametrize("select", ["paper", "fedcs", "longterm_auction"])
def test_selection_cli_matches_jax_cli(select, tmp_path, monkeypatch):
    import repro.launch.train as JTRAIN

    argv = ["--mode", "selection", "--clients", "2000", "--rounds", "20",
            "--scheme-select", select, "--quiet"]
    out = tmp_path / "jax.json"
    monkeypatch.setattr("sys.argv", ["train", *argv, "--out", str(out)])
    JTRAIN.main()
    want = json.loads(out.read_text())
    got = TRAIN.main(["--device", "cpu", *argv])
    assert set(want) <= set(got)
    for k in ("mode", "scheme", "scheme_select", "clients", "clusters",
              "rounds", "num_winners"):
        assert got[k] == want[k], k
    for k in ("energy_std", "mean_bid", "server_reward",
              "client_reward_sum", "final_energy_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["rounds_per_s"] > 0 and got["compile_s"] >= 0


def test_selection_cli_no_warm_rerun_and_needs_a_gpu(monkeypatch):
    got = TRAIN.main(["--device", "cpu", "--mode", "selection", "--clients",
                      "500", "--rounds", "3", "--no-warm-rerun", "--quiet",
                      "--scheme", "random"])
    assert got["compile_s"] is None and len(got["num_winners"]) == 3
    assert got["num_winners"] == [50, 50, 50]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRAIN.main(["--mode", "selection", "--clients", "500", "--rounds",
                    "3", "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.synthetic_fleet(FLConfig(num_clients=5), rng.PRNGKey(0))


CLI = ["--device", "cpu", "--clients", "12", "--clusters", "3", "--rounds",
       "2", "--pool", "1200", "--quiet"]


# the defaults (gradient_cluster_auction under paper) run in
# tests/test_torch_slice.py
@pytest.mark.parametrize("flag", [
    ["--scheme", "gradient_cluster_random"],
    ["--scheme", "weights_cluster_random"], ["--scheme", "random"],
    ["--scheme-select", "random"],
    ["--scheme-select", "fedcs", "--fedcs-deadline", "1.2",
     "--straggler-profile", "uniform"],
    ["--scheme-select", "longterm_auction"]])
def test_paper_cli_runs_every_scheme(flag):
    out = TRAIN.main(CLI + flag)
    assert out["device"] == "cpu" and len(out["selected"]) == 2
    assert np.isfinite(out["test_acc"][-1]) and out["params_finite"]
    assert all(len(set(s)) == len(s) for s in out["selected"])
