"""The port's fleet dynamics (repro_torch.sim.dynamics, the dynamics
round step and the server's degraded aggregation paths) against the JAX
package's: ``rng.bernoulli``, ``fault_step`` (every straggler profile),
``update_staleness``, ``outcome_metrics``, ``split_outcomes``,
``staleness_weight`` and ``host_replacement_mask`` on shared keys and
inputs; the server's selections and outcome codes against the JAX
sequential server under ``churn 0.25, deadline 1.2, buffered`` on each of
the port's runtimes; churn-0 bit identity; buffered without faults
against the synchronous oracle; zero-survivor rounds; and a buffered
run's event log under both validators.  Fixtures at
tests/test_dynamics.py's size (N=10, pool 700, J=3, 3 rounds, seed 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro.configs.base import FLConfig as JConfig
from repro.core import schemes as JSCH
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro.obs import schema as JSCHEMA
from repro.sim import dynamics as JDYN
from repro_torch import obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import schemes as TSCH
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.obs import schema as TSCHEMA
from repro_torch.sim import dynamics as TDYN

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=3,
          local_epochs=1, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)
FAULTY = dict(churn=0.25, deadline=1.2, aggregation="buffered",
              buffer_goal=2)


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


def _assert_params_equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _key(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


# ----------------------------------------------------------------------
# the fault model's pieces, bit for bit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.25, 1.0, 0.1, 0.3])
@pytest.mark.parametrize("shape", [(10,), (1000,), (7, 33)])
def test_bernoulli_matches_jax(p, shape):
    jk, tk = _key(11)
    want = np.asarray(jax.random.bernoulli(jk, p, shape))
    got = rng.bernoulli(tk, p, shape, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    if p == 0.0:
        assert not got.any()
    if p == 1.0:
        assert got.all()


def _fleet(n, seed):
    r = np.random.default_rng(seed)
    win = r.uniform(size=n) < 0.4
    avail = r.uniform(size=n) < 0.8
    residual = r.uniform(0.0, 100.0, n).astype(np.float32)
    sizes = r.integers(0, 400, n).astype(np.int32)
    return win, avail, residual, sizes


@pytest.mark.parametrize("profile", TDYN.STRAGGLER_PROFILES)
@pytest.mark.parametrize("churn,deadline", [(0.25, 1.2), (0.0, 0.0),
                                            (1.0, 0.9), (0.1, 1e-6)])
def test_fault_step_matches_jax(profile, churn, deadline):
    kw = dict(num_clients=300, churn=churn, deadline=deadline,
              straggler_profile=profile)
    jcfg, tcfg = JConfig(**kw), FLConfig(**kw)
    win, avail, residual, sizes = _fleet(300, 5)
    jstep = jax.jit(JDYN.fault_step, static_argnums=0)
    for seed in range(3):
        jk, tk = _key(seed)
        jo, jl, ja = jstep(jcfg, jk, *map(jnp.asarray, (win, avail,
                                                         residual, sizes)))
        to, tl, ta = TDYN.fault_step(tcfg, tk, *map(torch.tensor, (
            win, avail, residual, sizes)))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
        assert to.dtype == torch.int32
        if churn == 1.0:              # every winner drops mid-round
            assert (to.numpy()[win] == TDYN.DROPPED).all()
            assert not (ta.numpy() & win).any()


def test_codes_keys_and_init_match_jax():
    for name in ("NOT_SELECTED", "COMPLETED", "LATE", "DROPPED",
                 "STRAGGLER_PROFILES"):
        assert getattr(TDYN, name) == getattr(JDYN, name)
    cfg = dict(num_clients=7, seed=12)
    np.testing.assert_array_equal(
        TDYN.dynamics_key(FLConfig(**cfg)).numpy(),
        np.asarray(JDYN.dynamics_key(JConfig(**cfg))))
    avail = TDYN.init_dynamics(FLConfig(**cfg), "cpu").avail
    assert avail.dtype == torch.bool and avail.all() and avail.shape == (7,)


def test_staleness_metrics_split_and_weight_match_jax():
    r = np.random.default_rng(2)
    stale = r.integers(0, 6, 50).astype(np.int32)
    out = r.integers(0, 4, 50).astype(np.int32)
    np.testing.assert_array_equal(
        TDYN.update_staleness(torch.tensor(stale), torch.tensor(out)).numpy(),
        np.asarray(JDYN.update_staleness(jnp.asarray(stale),
                                         jnp.asarray(out))))
    tm = TDYN.outcome_metrics(torch.tensor(out), torch.tensor(stale))
    jm = JDYN.outcome_metrics(jnp.asarray(out), jnp.asarray(stale))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    sel = np.flatnonzero(out > 0)
    for a, b in zip(TDYN.split_outcomes(sel, out),
                    JDYN.split_outcomes(sel, out)):
        np.testing.assert_array_equal(a, b)
    for alpha in (0.0, 0.5, 1.0):
        for tau in (0, 1, 3, 10):
            assert TDYN.staleness_weight(
                FLConfig(staleness_alpha=alpha), tau) == \
                JDYN.staleness_weight(JConfig(staleness_alpha=alpha), tau)


@pytest.mark.parametrize("select", ["paper", "fedcs", "longterm_auction"])
@pytest.mark.parametrize("profile", TDYN.STRAGGLER_PROFILES)
@pytest.mark.parametrize("deadline", [0.0, 0.6, 1.2])
def test_host_replacement_mask_matches_jax(select, profile, deadline):
    kw = dict(scheme_select=select, straggler_profile=profile,
              deadline=deadline)
    sizes = np.random.default_rng(4).integers(0, 900, 40)
    want = JSCH.host_replacement_mask(JConfig(**kw), sizes)
    got = TSCH.host_replacement_mask(FLConfig(**kw), sizes)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the server against the JAX server, and across the port's runtimes
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_faulty(data):
    JOBS.OBS.reset()
    train, clients, test_batch = data
    srv = JServer(JConfig(**dict(KW, **FAULTY)), j_adapter("mnist"),
                  train.x, train.y, clients, test_batch)
    srv.run()
    return srv


@pytest.mark.parametrize("runtime", ["sequential", "vectorized", "device"])
def test_outcomes_and_selections_match_jax_server(data, jax_faulty,
                                                  runtime):
    srv = _server(data, runtime=runtime, **FAULTY)
    logs = srv.run()
    assert [l.selected.tolist() for l in logs] == \
        [l.selected.tolist() for l in jax_faulty.logs]
    assert [o.tolist() for o in srv.outcome_log] == \
        [o.tolist() for o in jax_faulty.outcome_log]
    codes = np.concatenate(srv.outcome_log)
    assert {TDYN.COMPLETED, TDYN.LATE} <= set(codes.tolist())
    np.testing.assert_array_equal(srv._host_history,
                                  jax_faulty._host_history)
    np.testing.assert_array_equal(srv._host_avail, jax_faulty._host_avail)
    for k, v in jax_faulty.params.items():
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for a, b in zip(logs, jax_faulty.logs):
        np.testing.assert_allclose(a.energy_std, b.energy_std, rtol=1e-5)
        np.testing.assert_allclose(a.test_loss, b.test_loss, rtol=1e-4)


def test_churn_zero_bit_identical_to_plain_config(data):
    # every dynamics knob changed except churn/deadline (both 0): the run
    # must not see any of it
    dyn0 = dict(churn=0.0, deadline=0.0, straggler_profile="lognormal",
                aggregation="buffered", buffer_goal=2, staleness_alpha=1.0)
    assert not FLConfig(**dyn0).dynamics_enabled
    sa, sb = _server(data), _server(data, **dyn0)
    la, lb = sa.run(), sb.run()
    assert sb.state.staleness is None
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x.selected, y.selected)
        assert x.mean_bid == y.mean_bid and x.energy_std == y.energy_std
    _assert_params_equal(sa.params, sb.params)


def test_buffered_without_faults_matches_sync_oracle(data):
    sa = _server(data)
    sb = _server(data, churn=0.0, deadline=1e9, aggregation="buffered")
    assert sb.dynamics
    la, lb = sa.run(), sb.run()
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x.selected, y.selected)
    assert all((o == TDYN.COMPLETED).all() for o in sb.outcome_log)
    for k in sa.params:
        np.testing.assert_allclose(sa.params[k].numpy(),
                                   sb.params[k].numpy(), rtol=2e-5,
                                   atol=2e-6)


def test_zero_survivor_rounds_pass_params_through(data):
    mem = obs.configure(memory=True)
    srv = _server(data, churn=1.0, rejoin_prob=0.0, replace_dropped=False)
    p0 = {k: v.clone() for k, v in srv.params.items()}
    logs = srv.run()
    _assert_params_equal(p0, srv.params)
    assert obs.OBS.counters.get("round/empty", 0) == 3
    names = [e.get("name") for e in mem.events if e["kind"] == "dynamics"]
    assert names.count("round/empty") == 3
    assert all(np.isfinite(l.test_acc) for l in logs)
    assert all((o == TDYN.DROPPED).all() for o in srv.outcome_log)
    assert int(srv.state.staleness.min()) == 3


def test_buffered_folds_and_schema_valid_log(data, tmp_path):
    path = str(tmp_path / "events.jsonl")
    mem = obs.configure(jsonl=path, memory=True)
    srv = _server(data, churn=0.2, deadline=0.8, aggregation="buffered",
                  buffer_goal=1, rounds=4)
    srv.run()
    for v in srv.params.values():
        assert torch.isfinite(v).all()
    assert (np.concatenate(srv.outcome_log) == TDYN.LATE).any()
    folds = [e for e in mem.events
             if e["kind"] == "dynamics" and e.get("name") == "buffer/fold"]
    assert folds and all(f["entries"] >= 1 for f in folds)
    obs.OBS.reset()
    events = TSCHEMA.load_jsonl(path)
    assert JSCHEMA.validate_events(events, rounds=4, eval_every=1) == []
    assert TSCHEMA.validate_events(events, rounds=4, eval_every=1) == []
    spans = [e["name"] for e in events if e["kind"] == "span"]
    assert "round/train_late" in spans and "round/buffer_fold" in spans
