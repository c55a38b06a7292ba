"""The port's self-healing server (the divergence watchdog, the defended
checkpoints, buffered aggregation under quarantine) against the JAX
package's: the watchdog's NaN storm (tests/test_selfheal.py's knobs) on
every runtime — the JAX run's winners, rollbacks and restored rounds,
finite params within 1e-4, the log valid under both schemas; the rollback
policy (server step decay, tightening from the current state); a
watchdog-on clean run bit-identical to off, undefended and defended; a
ring entry unchanged after more rounds (the port's tensors are mutable,
the JAX package's arrays are not); defended checkpoints (tree keys equal
to the JAX server's, a JAX checkpoint resumed by the port and the port's
by the JAX package, bit-exact resume); and the buffered late cohorts
folding with zero and with scaled mass, against the JAX server under
churn, deadlines and NaN adversaries.  Fixtures at tests/test_selfheal.py's
size (N=10, pool 700, J=3, seed 3); and single rounds of the reference
benchmark's self-healing cell from the JAX package's own states."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro.checkpoint import io as JCKPT
from repro.configs.base import FLConfig as JConfig
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro.obs import schema as JSCHEMA
from repro_torch import obs
from repro_torch.checkpoint import io as CKPT
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer, _BufferedUpdate
from repro_torch.obs import schema as TSCHEMA
from repro_torch.sim import dynamics as TDYN

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

RUNTIMES = ("sequential", "vectorized", "device")
KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=3,
          local_epochs=1, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)
STORM = dict(rounds=4, eval_every=1, adversary_frac=0.3, attack="nan",
             defense="none", watchdog="on", watchdog_ring=3)
SELFHEAL = dict(adversary_frac=0.3, attack="sub_clip", defense="clip",
                defense_mode="adaptive", reputation_mode="price",
                watchdog="on")
BUFFERED = dict(rounds=4, churn=0.2, deadline=1.1, aggregation="buffered",
                buffer_goal=1, buffer_timeout=1, adversary_frac=0.3,
                attack="nan", defense="median")


@pytest.fixture(autouse=True)
def _obs_reset():
    obs.OBS.reset()
    JOBS.OBS.reset()
    yield
    obs.OBS.reset()
    JOBS.OBS.reset()


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients, {"x": test.x[:64], "y": test.y[:64]}


def _server(data, **kw):
    train, clients, test_batch = data
    return FederatedServer(FLConfig(**dict(KW, **kw)),
                           cnn_adapter("mnist", "cpu"), train.x, train.y,
                           clients, test_batch, device="cpu")


def _jserver(data, **kw):
    train, clients, test_batch = data
    return JServer(JConfig(**dict(KW, **kw)), j_adapter("mnist"), train.x,
                   train.y, clients, test_batch)


def _assert_params_equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _rollbacks(events):
    return [(e["round"], e["restored_round"], e["reason"], e["rollbacks"])
            for e in events
            if e["kind"] == "watchdog" and e.get("name") == "rollback"]


# ----------------------------------------------------------------------
# the watchdog against the JAX server
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_storm(data):
    JOBS.OBS.reset()
    mem = JOBS.OBS.configure(memory=True)
    srv = _jserver(data, **STORM)
    srv.run()
    JOBS.OBS.flush()
    events = list(mem.events)
    JOBS.OBS.reset()
    return srv, events


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_watchdog_nan_storm_matches_jax(data, jax_storm, runtime, tmp_path):
    ref, ref_events = jax_storm
    path = str(tmp_path / "wd.jsonl")
    obs.configure(jsonl=path)
    srv = _server(data, runtime=runtime, **STORM)
    logs = srv.run()
    obs.OBS.close_sinks()
    assert [l.round for l in logs] == [0, 1, 2, 3]
    assert [l.selected.tolist() for l in logs] == \
        [l.selected.tolist() for l in ref.logs]
    assert srv.watchdog_totals == ref.watchdog_totals
    assert srv.watchdog_totals["rollbacks"] >= 1
    events = TSCHEMA.load_jsonl(path)
    assert _rollbacks(events) == _rollbacks(ref_events)
    assert _rollbacks(events)[0][2] == "non_finite_eval"
    for k, v in ref.params.items():
        assert torch.isfinite(srv.params[k]).all()
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert srv._srv_lr == float(ref._srv_lr)
    np.testing.assert_array_equal(srv.key.numpy().astype(np.uint32),
                                  np.asarray(ref.key))
    for validate in (TSCHEMA.validate_events, JSCHEMA.validate_events):
        assert validate(events, rounds=4, eval_every=1,
                        min_rollbacks=1) == []


def test_watchdog_rollback_decays_lr_and_tightens(data):
    srv = _server(data, adversary_frac=0.3, attack="nan", defense="clip",
                  clip_mult=1e9, watchdog="on", watchdog_lr_decay=0.5,
                  watchdog_tighten=2.0)
    assert srv._srv_lr == 1.0
    assert float(srv._defense_state.tighten) == 1.0
    srv._wd_snapshot(-1)
    srv._wd_rollback("loss_spike", 0)
    assert srv._srv_lr == 0.5
    assert float(srv._defense_state.tighten) == 2.0
    srv._wd_rollback("loss_spike", 1)       # tightened from the current
    assert srv._srv_lr == 0.25
    assert float(srv._defense_state.tighten) == 4.0
    assert srv.watchdog_totals["rollbacks"] == 2


@pytest.mark.parametrize("defended", [False, True])
def test_watchdog_on_clean_run_bit_identical_to_off(data, defended):
    kw = (dict(adversary_frac=0.3, attack="scale", defense="trimmed")
          if defended else {})
    off = _server(data, **kw)
    logs_off = off.run()
    on = _server(data, watchdog="on", **kw)
    logs_on = on.run()
    assert on.watchdog_totals["rollbacks"] == 0
    assert on.watchdog_totals["snapshots"] >= 1
    _assert_params_equal(off.params, on.params)
    for a, b in zip(logs_off, logs_on):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.mean_bid == b.mean_bid and a.test_acc == b.test_acc
    if defended:
        assert torch.equal(off.state.strikes, on.state.strikes)


def test_ring_entry_unchanged_after_more_rounds(data):
    srv = _server(data, rounds=6, **SELFHEAL)
    srv.run(rounds=2)
    entry = srv._wd_ring[-1]
    leaves = dict(CKPT._leaves_with_paths(entry.tree))
    copies = {k: (v.clone() if isinstance(v, torch.Tensor)
                  else np.array(v, copy=True)) for k, v in leaves.items()}
    assert any(k.startswith("defense_state/") for k in copies)
    for t in range(2, 6):                  # rounds that move every leaf
        srv._dispatch_round(t, eval_now=True)
        srv._flush_pending()
    assert srv.logs[-1].round == 5 and srv._wd_ring[-1] is not entry
    assert not torch.equal(srv.params["c1_w"], copies["params/c1_w"])
    for k, v in dict(CKPT._leaves_with_paths(entry.tree)).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, copies[k]), k
        else:
            np.testing.assert_array_equal(v, copies[k], err_msg=k)


# ----------------------------------------------------------------------
# defended checkpoints
# ----------------------------------------------------------------------

def test_ckpt_tree_keys_equal_the_jax_servers(data):
    kw = dict(SELFHEAL, churn=0.2, deadline=1.1)
    t = CKPT._flatten(_server(data, **kw)._ckpt_tree())
    j = JCKPT._flatten(_jserver(data, **kw)._ckpt_tree())
    assert list(t) == list(j)
    assert {"defense_state/.clip_ema", "defense_state/.tighten",
            "server_lr"} <= set(t)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k


def test_resume_is_bit_exact_vs_uninterrupted(data, tmp_path):
    ref = _server(data, rounds=4, **SELFHEAL)
    logs_ref = ref.run()
    path = str(tmp_path / "ck")
    _server(data, rounds=4, **SELFHEAL).run(rounds=3, checkpoint_every=2,
                                            checkpoint_path=path)
    resumed = _server(data, rounds=4, **SELFHEAL)
    logs_res = resumed.run(checkpoint_path=path, resume=True)
    assert [l.round for l in logs_res] == [2, 3]
    _assert_params_equal(ref.params, resumed.params)
    for a, b in zip(logs_ref[2:], logs_res):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.test_acc == b.test_acc
    assert torch.equal(ref.state.strikes, resumed.state.strikes)
    for f in ("clip_ema", "mad_ema", "pressure", "tighten"):
        assert torch.equal(getattr(ref._defense_state, f),
                           getattr(resumed._defense_state, f)), f
    assert ref._srv_lr == resumed._srv_lr


def test_jax_defended_checkpoint_resumes_in_the_port(data, tmp_path):
    ref = _jserver(data, rounds=4, **SELFHEAL)
    ref_logs = ref.run()
    path = str(tmp_path / "jax_ck")
    _jserver(data, rounds=4, **SELFHEAL).run(rounds=3, checkpoint_every=2,
                                             checkpoint_path=path)
    srv = _server(data, rounds=4, **SELFHEAL)
    with pytest.warns(UserWarning, match="treedef mismatch"):
        logs = srv.run(checkpoint_path=path, resume=True)
    assert [l.round for l in logs] == [2, 3]
    for a, b in zip(ref_logs[2:], logs):
        np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(srv.state.strikes.numpy(),
                                  np.asarray(ref.state.strikes))
    for k, v in ref.params.items():
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(srv._defense_state.clip_ema),
                               float(ref._defense_state.clip_ema),
                               rtol=1e-5)


def test_port_defended_checkpoint_restores_in_the_jax_package(data,
                                                             tmp_path):
    path = str(tmp_path / "port_ck")
    _server(data, rounds=4, **SELFHEAL).run(rounds=3, checkpoint_every=2,
                                            checkpoint_path=path)
    jsrv = _jserver(data, rounds=4, **SELFHEAL)
    with pytest.warns(UserWarning, match="treedef mismatch"):
        assert jsrv.load_checkpoint(path) == 2
    mid = _server(data, rounds=4, **SELFHEAL)
    mid.run(rounds=2)
    for k, v in mid.params.items():
        np.testing.assert_array_equal(np.asarray(jsrv.params[k]), v.numpy())
    np.testing.assert_array_equal(np.asarray(jsrv.state.strikes),
                                  mid.state.strikes.numpy())
    for f in ("clip_ema", "mad_ema", "pressure", "tighten"):
        assert float(getattr(jsrv._defense_state, f)) == float(
            getattr(mid._defense_state, f)), f
    assert float(jsrv._srv_lr) == mid._srv_lr
    assert jsrv._wd_rollbacks == mid._wd_rollbacks


# ----------------------------------------------------------------------
# buffered aggregation under quarantine
# ----------------------------------------------------------------------

def test_fully_quarantined_late_cohort_folds_zero_mass(data):
    mem = obs.configure(memory=True)
    srv = _server(data, **BUFFERED)
    params0 = srv.params
    srv._late_buffer.append(_BufferedUpdate(
        delta={k: torch.ones_like(v) for k, v in srv.params.items()},
        mass=500.0, round=0, arrival=1, mass_scale=torch.tensor(0.0)))
    assert srv._maybe_fold_buffer(2, force=True) == 0
    assert srv._late_buffer == []
    _assert_params_equal(params0, srv.params)
    assert obs.OBS.counters.get("dyn/buffer_all_quarantined", 0) == 1
    obs.OBS.flush()
    assert "buffer/all_quarantined" in [
        e.get("name") for e in mem.events if e["kind"] == "dynamics"]


def test_partially_quarantined_late_cohort_scales_mass(data):
    srv = _server(data, **BUFFERED)
    params0 = srv.params
    ones = {k: torch.ones_like(v) for k, v in srv.params.items()}
    for scale in (0.0, 1.0):
        srv._late_buffer.append(_BufferedUpdate(
            delta=ones, mass=100.0, round=1, arrival=2,
            mass_scale=torch.tensor(scale)))
    assert srv._maybe_fold_buffer(2, force=True) == 2
    w = float(np.float32(TDYN.staleness_weight(srv.cfg, 1)))
    for k in params0:
        np.testing.assert_allclose(srv.params[k].numpy(),
                                   params0[k].numpy() + w, rtol=1e-6)


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_buffered_defended_run_matches_jax(data, runtime):
    ref = _jserver(data, **BUFFERED) if runtime == "sequential" else None
    srv = _server(data, runtime=runtime, **BUFFERED)
    logs = srv.run()
    assert len(logs) == 4
    assert all(torch.isfinite(v).all() for v in srv.params.values())
    assert srv.defense_totals["quarantined"] > 0
    codes = np.concatenate(srv.outcome_log)
    assert (codes == TDYN.LATE).any()
    if ref is None:
        return
    ref.run()
    assert [l.selected.tolist() for l in logs] == \
        [l.selected.tolist() for l in ref.logs]
    assert [o.tolist() for o in srv.outcome_log] == \
        [o.tolist() for o in ref.outcome_log]
    np.testing.assert_array_equal(srv.state.strikes.numpy(),
                                  np.asarray(ref.state.strikes))
    assert srv.defense_totals == ref.defense_totals
    for k, v in ref.params.items():
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_undefended_nan_attack_flags_divergence(data, tmp_path):
    path = str(tmp_path / "ev.jsonl")
    obs.configure(jsonl=path)
    srv = _server(data, eval_every=1, adversary_frac=0.3, attack="nan",
                  defense="none")
    logs = srv.run()
    obs.OBS.close_sinks()
    assert any(not l.eval_skipped and not np.isfinite(l.test_loss)
               for l in logs)
    events = TSCHEMA.load_jsonl(path)
    assert any(e["kind"] == "defense" and e.get("name") == "round/diverged"
               for e in events)
    for validate in (TSCHEMA.validate_events, JSCHEMA.validate_events):
        assert validate(events, rounds=3, eval_every=1) == []


def test_strikes_ban_repeat_offenders(data):
    srv = _server(data, rounds=6, adversary_frac=0.3, attack="nan",
                  defense="median", strike_threshold=1.0, strike_decay=1.0)
    adv = srv._adv_mask
    logs = srv.run()
    strikes = srv.state.strikes.numpy()
    assert (strikes[~adv] == 0).all()
    banned_at, struck = {}, set()
    for log in logs:
        for c in log.selected:
            assert int(c) not in banned_at, (c, log.round)
        for c in log.selected:
            if adv[int(c)]:
                struck.add(int(c))
                banned_at.setdefault(int(c), log.round + 1)
    assert struck
    assert srv.defense_totals["banned_final"] == len(struck)


# ----------------------------------------------------------------------
# the reference benchmark's self-healing cell from the JAX package's state
# ----------------------------------------------------------------------

# the JAX package's selfheal cell (32 clients, 4 clusters, device runtime)
# before and after single rounds from 15 to 90, written by
# tools/robust_drift.py anchors: whole runs drift apart once the adaptive
# band reads trained params, so each round is held from JAX's own state
ANCHORS = Path(__file__).resolve().parents[1] / "tools" / "robust_anchors"
ANCHOR_META = json.loads((ANCHORS / "anchors.json").read_text())


@pytest.fixture(scope="module")
def bench_data():
    m = ANCHOR_META
    train, test = make_image_dataset(m["dataset"], n_train=m["pool"],
                                     n_test=m["test"],
                                     seed=m["config"]["seed"])
    clients = partition_clients(train.y, JConfig(**m["config"]),
                                seed=m["config"]["seed"])
    return train, clients, {"x": test.x[:m["test"]], "y": test.y[:m["test"]]}


@pytest.mark.parametrize("t", sorted(ANCHOR_META["anchors"], key=int))
def test_benchmark_selfheal_round_from_jax_state_takes_jax_decisions(
        bench_data, t):
    want, t = ANCHOR_META["anchors"][t], int(t)
    train, clients, test_batch = bench_data
    srv = FederatedServer(FLConfig(**ANCHOR_META["config"]),
                          cnn_adapter(ANCHOR_META["dataset"], "cpu"),
                          train.x, train.y, clients, test_batch,
                          device="cpu")
    mem = obs.OBS.configure(memory=True)
    logs = srv.run(rounds=t + 1, checkpoint_path=str(ANCHORS / f"round{t}"),
                   resume=True)
    rows = [e for e in mem.events if e["kind"] == "round"]
    assert [l.round for l in logs] == [t]
    assert logs[0].selected.tolist() == want["selected"]
    for k in ("num_quarantined", "num_screened", "num_banned"):
        assert int(rows[0][k]) == want[k], k
    # the state the next round reads: strikes and integer leaves exact,
    # every other leaf (params, energy residuals, the defense EMAs)
    # within the engine bound 1e-4
    got = CKPT._flatten(srv._ckpt_tree())
    with np.load(ANCHORS / f"round{t + 1}.npz") as f:
        nxt = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(nxt)
    for k in got:
        d = float(np.abs(got[k].astype(np.float64) - nxt[k]).max())
        if np.issubdtype(nxt[k].dtype, np.floating) and k != \
                "state/.strikes":
            assert d < 1e-4, k
        else:
            assert d == 0.0, k
