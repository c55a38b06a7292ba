"""The port's event stream (repro_torch.obs) against the JAX package's
(repro.obs): registry, span and sink mechanics, the schema copy (same
kinds, required fields and errors as the reference validator), a port
run's JSONL under both validators, the neutrality of sinks (bit-identical
logs and params, the same counted transfers), the verbose-print eval
cadence, the counted transfers and the sync auditor's mode bookkeeping
on the CPU, and the profiler capture.  Fixtures at tests/test_obs.py's
size (N=10, pool 700, J=3, seed 3)."""
import io
import math
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro.obs import schema as JSCHEMA
from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core import schemes as TSCH
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.obs import schema as TSCHEMA
from repro_torch.obs import torchmon
from repro_torch.obs.sinks import sanitize_event

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=2,
          local_epochs=1, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)


@pytest.fixture(scope="module")
def data():
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients, {"x": test.x[:64], "y": test.y[:64]}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with obs disabled (OBS is a process
    singleton)."""
    obs.OBS.reset()
    yield
    obs.OBS.reset()


def _server(data, **kw):
    train, clients, test_batch = data
    return FederatedServer(FLConfig(**dict(KW, **kw)),
                           cnn_adapter("mnist", "cpu"), train.x, train.y,
                           clients, test_batch, device="cpu")


def _canon(v):
    return "nan" if isinstance(v, float) and math.isnan(v) else v


def _log_tuples(logs):
    return [tuple(map(_canon, (l.round, l.test_acc, l.test_loss,
                               l.energy_std, l.mean_bid, l.server_reward,
                               l.client_reward_sum, l.vds_gap)))
            + (tuple(l.selected.tolist()),) for l in logs]


def _assert_params_equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------------
# registry / span / sink mechanics
# ----------------------------------------------------------------------

def test_disabled_is_noop():
    assert not obs.OBS.enabled
    obs.SPANS.clear()
    with obs.span("x", round=0):
        with obs.span("y"):
            pass
    obs.OBS.event("round", round=0)
    obs.OBS.record_round(1, test_acc=1.0)
    obs.flush()
    # nothing buffered or emitted; the span only timed its block
    assert obs.OBS._buffer == []
    assert set(obs.SPANS) == {"x", "y"} and obs.SPANS["x"] >= 0.0


def test_span_nesting_and_schema():
    mem = obs.configure(memory=True)
    with obs.span("run/cluster"):
        with obs.span("cluster/kmeans", k=3):
            pass
    with obs.span("round/dispatch", round=0):
        with obs.span("round/select", round=0):
            pass
    obs.OBS.record_round(0, test_acc=0.5, test_loss=1.0, energy_std=0.1,
                         mean_bid=0.2, vds_gap=0.3)
    with obs.span("round/drain", rounds=1):
        pass
    obs.flush()
    assert TSCHEMA.validate_events(mem.events, rounds=1, eval_every=1) == []
    assert JSCHEMA.validate_events(mem.events, rounds=1, eval_every=1) == []
    spans = {e["name"]: e for e in mem.events if e["kind"] == "span"}
    assert spans["cluster/kmeans"]["parent"] == spans["run/cluster"]["id"]
    assert spans["cluster/kmeans"]["depth"] == 1
    assert spans["round/select"]["parent"] == spans["round/dispatch"]["id"]
    assert spans["run/cluster"]["parent"] is None
    # meta keys clashing with schema fields are renamed, not dropped
    with obs.span("x", kind="boom", note="ok"):
        pass
    obs.flush()
    e = [v for v in mem.events if v.get("name") == "x"][0]
    assert e["kind"] == "span" and e["meta_kind"] == "boom" \
        and e["note"] == "ok"


def test_sinks_sanitize_nan_and_jsonl_roundtrip(tmp_path):
    path, csv = str(tmp_path / "ev.jsonl"), str(tmp_path / "ev.csv")
    obs.configure(jsonl=path, csv=csv)
    obs.OBS.record_round(0, test_acc=float("nan"), test_loss=float("inf"),
                         energy_std=0.5, mean_bid=0.1, vds_gap=0.2)
    obs.OBS.counter("pack/buckets", 3)
    obs.flush()
    for load in (TSCHEMA.load_jsonl, JSCHEMA.load_jsonl):
        events = load(path)         # strict JSON: NaN would raise here
        row = [e for e in events if e["kind"] == "round"][0]
        assert row["test_acc"] is None and row["test_loss"] is None
        assert row["energy_std"] == 0.5
        ctr = [e for e in events if e["kind"] == "counter"][0]
        assert ctr["name"] == "pack/buckets" and ctr["value"] == 3
    assert sanitize_event({"a": math.nan, "b": 1.5}) == {"a": None,
                                                         "b": 1.5}
    obs.OBS.reset()                 # closes the sinks
    with open(csv) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("kind,ts,name,round")
    assert any(line.startswith('"round"') and ",null," not in line
               for line in lines[1:])


def test_schema_constants_equal_the_reference():
    assert TSCHEMA.KINDS == JSCHEMA.KINDS
    assert TSCHEMA.REQUIRED == JSCHEMA.REQUIRED
    assert TSCHEMA.STATEFUL_SCHEMES == JSCHEMA.STATEFUL_SCHEMES
    assert TSCHEMA.STATEFUL_SCHEMES == TSCH.stateful_scheme_names()


def _bad_streams():
    base = {"kind": "span", "ts": 1.0, "name": "a", "id": 1,
            "parent": None, "depth": 0, "t0": 0.0, "dur_s": 1.0}
    child = {"kind": "span", "ts": 3.0, "name": "b", "id": 2,
             "parent": 1, "depth": 1, "t0": 0.5, "dur_s": 5.0}
    r = {"kind": "round", "ts": 1.0, "round": 1, "test_acc": 0.5,
         "test_loss": 1.0, "energy_std": 0.1, "mean_bid": 0.2,
         "vds_gap": 0.3}
    r0 = dict(r, round=0, test_acc=None, test_loss=None)
    disp = [dict(base, id=10 + t, name="round/dispatch", round=t)
            for t in range(2)]
    drain = dict(base, id=20, name="round/drain")
    rb = {"kind": "watchdog", "ts": 1.0, "name": "rollback", "round": 1}
    return {
        "escaping_child": ([base, child], {}),
        "wrong_depth": ([base, dict(child, t0=0.1, dur_s=0.1, depth=4)], {}),
        "null_due_eval": ([r0, r, *disp, drain],
                          dict(rounds=2, eval_every=2)),
        "duplicate_row": ([r, dict(r), *disp, drain],
                          dict(rounds=2, eval_every=2)),
        "unknown_kind_and_bad_ts": ([{"kind": "nope", "ts": 0},
                                     dict(r, ts=-1.0), "not a dict"], {}),
        "missing_rounds_and_drain": ([r], dict(rounds=3)),
        "scheme_scalars": ([r], dict(scheme_select="longterm_auction")),
        "price_scalars": ([dict(r, trust_mean=1.5)],
                          dict(reputation_mode="price")),
        "rollbacks": ([rb], dict(min_rollbacks=2)),
        "missing_parent": ([dict(child, parent=99)], {}),
    }


@pytest.mark.parametrize("name", sorted(_bad_streams()))
def test_validators_agree_on_bad_streams(name):
    events, kw = _bad_streams()[name]
    want = JSCHEMA.validate_events(events, **kw)
    assert want, "the stream is meant to be invalid"
    assert TSCHEMA.validate_events(events, **kw) == want


# ----------------------------------------------------------------------
# a port run's stream under both validators
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(eval_every=2, rounds=3),
    dict(scheme_select="longterm_auction", churn=0.25, deadline=1.2,
         aggregation="buffered", buffer_goal=1, rounds=3)],
    ids=["plain", "longterm-dynamics"])
def test_port_run_jsonl_passes_both_validators(data, tmp_path, kw):
    path = str(tmp_path / "ev.jsonl")
    obs.configure(jsonl=path)
    srv = _server(data, **kw)
    srv.run()
    obs.OBS.reset()
    events = TSCHEMA.load_jsonl(path)
    check = dict(rounds=kw["rounds"], eval_every=kw.get("eval_every", 1),
                 scheme_select=kw.get("scheme_select", "paper"))
    assert JSCHEMA.validate_events(events, **check) == []
    assert TSCHEMA.validate_events(events, **check) == []
    kinds = {e["kind"] for e in events}
    assert {"meta", "round", "span", "jax_stats"} <= kinds
    names = [e["name"] for e in events if e["kind"] == "span"]
    assert names.count("round/dispatch") == kw["rounds"]
    assert "run/cluster" in names and "cluster/kmeans" in names
    if "churn" in kw:
        rows = [e for e in events if e["kind"] == "round"]
        assert all("num_completed" in e and "buffer_len" in e
                   and "budget_spent" in e for e in rows)


def test_sinks_attached_vs_none_bit_identical(data, tmp_path):
    kw = dict(churn=0.25, deadline=1.2, aggregation="buffered",
              buffer_goal=1, rounds=3, runtime="vectorized")
    st0 = obs.torch_stats.snapshot()
    srv0 = _server(data, **kw)
    logs0 = srv0.run()
    moved0 = obs.torch_stats.delta(st0)
    mem = obs.configure(jsonl=str(tmp_path / "ev.jsonl"), memory=True)
    st1 = obs.torch_stats.snapshot()
    srv1 = _server(data, **kw)
    logs1 = srv1.run()
    moved1 = obs.torch_stats.delta(st1)
    assert _log_tuples(logs0) == _log_tuples(logs1)
    assert [o.tolist() for o in srv0.outcome_log] == \
        [o.tolist() for o in srv1.outcome_log]
    _assert_params_equal(srv0.params, srv1.params)
    # the same counted transfers, by direction, calls and bytes
    assert moved0 == moved1 and moved1["d2h_calls"] > 0
    assert any(e["kind"] == "round" for e in mem.events)


def test_verbose_does_not_force_evals(data):
    rounds, eval_every = 5, 3
    srv_q = _server(data, eval_every=eval_every)
    logs_q = srv_q.run(rounds=rounds, verbose=False)
    srv_v = _server(data, eval_every=eval_every)
    with redirect_stdout(io.StringIO()) as cap:
        logs_v = srv_v.run(rounds=rounds, verbose=True)
    assert _log_tuples(logs_q) == _log_tuples(logs_v)
    _assert_params_equal(srv_q.params, srv_v.params)
    for l in logs_v:
        due = l.round % eval_every == 0 or l.round == rounds - 1
        assert math.isnan(l.test_acc) != due
    assert "round   0 acc=0." in cap.getvalue()


# ----------------------------------------------------------------------
# torchmon: counted transfers, the stats event, the auditor, the profiler
# ----------------------------------------------------------------------

def test_counted_transfers_and_stats_event():
    mem = obs.configure(memory=True)
    st0 = obs.torch_stats.snapshot()
    arr = np.ones((8, 4), np.float32)
    dev = obs.device_put({"a": arr, "b": (np.int32(3), None)}, "cpu")
    assert isinstance(dev["a"], torch.Tensor) and dev["b"][1] is None
    back = obs.device_get((dev["a"], torch.zeros(5, dtype=torch.int64)))
    assert isinstance(back[0], np.ndarray)
    np.testing.assert_array_equal(back[0], arr)
    d = obs.torch_stats.delta(st0)
    # a host array already on the target device moves nothing
    assert d["h2d_calls"] == 1 and d.get("h2d_bytes", 0) == 0
    assert d["d2h_bytes"] == arr.nbytes + 40 and d["d2h_calls"] == 1
    obs.torch_stats.note_shape(False)
    obs.torch_stats.note_shape(True)
    obs.flush()
    stats = [e for e in mem.events if e["kind"] == "jax_stats"]
    assert len(stats) == 1 and stats[0]["shape_hits"] >= 1
    obs.flush()                  # counters did not move: no second event
    assert len([e for e in mem.events if e["kind"] == "jax_stats"]) == 1


def test_sync_audit_mode_bookkeeping():
    seen = []

    class Probe:
        """A host leaf that records the mode in force at its copy."""

        def __array__(self, dtype=None, copy=None):
            seen.append(torchmon.sync_debug_mode())
            return np.zeros(2, np.float32)

    assert torchmon.sync_debug_mode() == 0
    with obs.sync_audit():
        assert torchmon.sync_debug_mode() == 2
        obs.device_put(Probe(), "cpu")
        assert torchmon.sync_debug_mode() == 2
        with obs.sync_audit("warn"):
            assert torchmon.sync_debug_mode() == 1
        assert torchmon.sync_debug_mode() == 2
    assert torchmon.sync_debug_mode() == 0
    assert seen == [0]           # the explicit copy runs under "default"
    with pytest.raises(ValueError):
        with obs.sync_audit():
            raise ValueError("restored on the way out")
    assert torchmon.sync_debug_mode() == 0


def test_audit_sync_run_matches_plain_run(data):
    kw = dict(churn=0.25, deadline=1.2, aggregation="buffered", rounds=4,
              runtime="vectorized")
    a, b = _server(data, **kw), _server(data, **kw)
    la, lb = a.run(), b.run(audit_sync=True, audit_warm_rounds=1)
    assert _log_tuples(la) == _log_tuples(lb)
    _assert_params_equal(a.params, b.params)
    assert torchmon.sync_debug_mode() == 0


def test_maybe_profile_writes_a_trace(tmp_path):
    with obs.maybe_profile(None):
        pass
    with obs.maybe_profile(""):
        pass
    out = tmp_path / "prof"
    with obs.maybe_profile(str(out)):
        torch.ones(4).sum()
    files = os.listdir(out)
    assert files == [f"trace.{os.getpid()}.json"]
    assert os.path.getsize(out / files[0]) > 0


def test_cli_takes_every_ported_flag_and_matches_the_jax_cli(tmp_path,
                                                             monkeypatch):
    """The port's CLI with the dynamics, event-stream, audit and profiler
    flags runs, and its result (the dynamics block, losses and energy)
    matches the JAX CLI's for the same flags."""
    import json

    from repro import obs as JOBS
    from repro.launch import train as JTRAIN
    from repro_torch.launch import train as TRAIN

    flags = ["--clients", "12", "--clusters", "3", "--pool", "1200",
             "--rounds", "3", "--quiet", "--churn", "0.25", "--deadline",
             "1.2", "--aggregation", "buffered", "--buffer-goal", "1"]
    jsonl, csv = str(tmp_path / "ev.jsonl"), str(tmp_path / "ev.csv")
    prof = tmp_path / "prof"
    port = TRAIN.main(["--device", "cpu", *flags, "--log-jsonl", jsonl,
                       "--log-csv", csv, "--audit-sync", "--profile-dir",
                       str(prof)])
    assert not obs.OBS.enabled           # the CLI detached its sinks
    out = str(tmp_path / "jax.json")
    monkeypatch.setattr("sys.argv", ["train", *flags, "--out", out])
    JOBS.OBS.reset()
    try:
        JTRAIN.main()
    finally:
        JOBS.OBS.reset()
    with open(out) as f:
        ref = json.load(f)
    assert port["dynamics"] == ref["dynamics"]
    assert port["dynamics"]["num_late"] > 0
    for k in ("energy_std", "mean_bid", "test_loss"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, err_msg=k)
    events = TSCHEMA.load_jsonl(jsonl)
    for validate in (TSCHEMA.validate_events, JSCHEMA.validate_events):
        assert validate(events, rounds=3, eval_every=1) == []
    with open(csv) as f:
        assert sum(line.startswith('"round"') for line in f) == 3
    assert len(os.listdir(prof)) == 1
