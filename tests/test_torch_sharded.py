"""The port's ``sharded`` runtime, ``device`` on a mesh, the cohort mesh
and rules, and the packer's ``client_multiple`` and counters, against
the JAX package at tests/test_sim.py's size (N=10, pool 700, J=3,
select_ratio 0.4, seed 3).

The meshes are made here, in process: a 1-device mesh and a mesh that
lists the CPU 8 times (8 shards on one device), given to the runtime
through a monkeypatched ``make_cohort_mesh``, as
tests/test_sim.py::test_sharded_runtime_on_forced_8_device_mesh forces
8 host devices for the JAX package.  The port is held to the JAX
package's ``vectorized`` runtime (its ``sharded`` runtime fails under
JAX 0.9, ROADMAP.md): the same winners, energy std and mean bid every
round, final params within 1e-4 (the reference's bound between its
runtimes).  Packing and tiers at ``client_multiple`` 8 are JAX's bit for
bit."""
import json

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as JTRAIN
from repro import obs as JOBS
from repro.configs.base import FLConfig as JConfig
from repro.core.adapters import cnn_adapter as j_adapter
from repro.core.server import FederatedServer as JServer
from repro.data.partition import partition_clients
from repro.data.synthetic import make_image_dataset
from repro.sharding import rules as JRULES
from repro.sim import cohort as JCO
from repro.sim import fleet as JFL
from repro_torch import interop, obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as TRAIN
from repro_torch.sharding import rules
from repro_torch.sim import cohort as TCO
from repro_torch.sim import fleet as TFL
from repro_torch.sim.engine import CohortEngine

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

N = 10
TOL = 1e-4
KW = dict(num_clients=N, num_clusters=3, select_ratio=0.4, rounds=2,
          local_epochs=2, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)
# tests/test_sim.py's forced-mesh configuration
FORCED = dict(KW, scheme="random")
CPU = torch.device("cpu")
MESHES = {"1": (CPU,), "8": (CPU,) * 8}


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
    return FederatedServer(FLConfig(**kw), cnn_adapter("mnist", "cpu"),
                           train.x, train.y, clients, test_batch,
                           device="cpu")


def _force_mesh(monkeypatch, devices):
    monkeypatch.setattr(MESH, "make_cohort_mesh",
                        lambda num_devices=0, device="cuda":
                        MESH.CohortMesh(devices))


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for k in a)


def _assert_same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ----------------------------------------------------------------------
# the packer and the store at client_multiple 8, bit for bit
# ----------------------------------------------------------------------

SELECTIONS = {"all": np.arange(N), "three": np.array([7, 0, 3]),
              "one": np.array([2])}


@pytest.mark.parametrize("multiple", [3, 8])
@pytest.mark.parametrize("sel_name", sorted(SELECTIONS))
def test_pack_cohort_client_multiple_bit_identical(data, sel_name,
                                                   multiple):
    train, clients, _ = data
    sel, hist = SELECTIONS[sel_name], np.arange(N) % 3
    jb = JCO.pack_cohort(train.x, train.y, clients, sel, hist,
                         JConfig(**KW), client_multiple=multiple)
    tb = TCO.pack_cohort(train.x, train.y, clients, sel, hist,
                         FLConfig(**KW), client_multiple=multiple)
    assert len(jb) == len(tb) > 0
    for j, t in zip(jb, tb):
        assert t.num_clients % multiple == 0
        assert j.batch_size == t.batch_size
        for f in ("client_idx", "xb", "yb", "step_mask", "weights"):
            _assert_same_arrays(getattr(j, f), getattr(t, f), f)


@pytest.mark.parametrize("multiple", [3, 8])
def test_fleet_store_client_multiple_bit_identical(data, multiple):
    train, clients, _ = data
    kw = dict(KW, select_ratio=0.9)
    js = JFL.FleetStore(train.x, train.y, clients, JConfig(**kw),
                        client_multiple=multiple)
    ts = TFL.FleetStore(train.x, train.y, clients, FLConfig(**kw),
                        client_multiple=multiple, device="cpu")
    assert len(js.classes) == len(ts.classes) > 1
    for j, t in zip(js.classes, ts.classes):
        assert j.tiers == t.tiers
        assert all(tier % multiple == 0 for tier in t.tiers)
        assert (j.bs, j.step_cap, j.n_cap) == (t.bs, t.step_cap, t.n_cap)
    hist = np.arange(N) % 3
    for jbs, tbs in ((js.warmup_batches(), ts.warmup_batches()),
                     (js.assemble(np.arange(N), hist),
                      ts.assemble(np.arange(N), hist))):
        assert len(jbs) == len(tbs)
        for j, t in zip(jbs, tbs):
            assert j.cls_id == t.cls_id
            for f in ("rows", "plans", "step_mask", "weights",
                      "client_idx"):
                _assert_same_arrays(getattr(j, f), getattr(t, f), f)


def test_fleet_store_holds_one_copy_per_mesh_device(data):
    train, clients, _ = data
    ts = TFL.FleetStore(train.x, train.y, clients, FLConfig(**KW),
                        client_multiple=8, device="cpu",
                        mesh=MESH.CohortMesh(MESHES["8"]))
    for c in ts.classes:
        assert len(c.xs) == len(c.ys) == 8
        # every shard on the store's own device reads the one copy
        assert all(x is c.x for x in c.xs) and all(y is c.y for y in c.ys)


# ----------------------------------------------------------------------
# the mesh and the rules
# ----------------------------------------------------------------------

def test_rules_match_the_jax_specs():
    def as_port(spec):
        return rules.REPLICATED if tuple(spec) == () else rules.DATA

    assert rules.cohort_param_spec() == as_port(JRULES.cohort_param_spec())
    assert rules.cohort_stacked_spec() == as_port(
        JRULES.cohort_stacked_spec())
    for port, jspecs in ((rules.cohort_bucket_specs(),
                          JRULES.cohort_bucket_specs()),
                         (rules.fleet_class_specs(),
                          JRULES.fleet_class_specs())):
        assert port == tuple(as_port(s) for s in jspecs)


def test_shard_of_splits_contiguously():
    a = np.arange(24).reshape(8, 3)
    t = torch.from_numpy(a)
    parts = [rules.shard_of(rules.DATA, a, s, 4) for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), a)
    assert all(p.shape == (2, 3) for p in parts)
    assert torch.equal(rules.shard_of(rules.DATA, t, 3, 4), t[6:])
    assert rules.shard_of(rules.REPLICATED, ("a", "b"), 1, 2) == "b"
    with pytest.raises(ValueError, match="equal shards"):
        rules.shard_of(rules.DATA, a, 0, 3)


def test_make_cohort_mesh_cpu_and_card_order(monkeypatch):
    mesh = MESH.make_cohort_mesh(4, "cpu")
    assert mesh.devices == (CPU,) and mesh.shape == {"data": 1, "model": 1}
    assert MESH.make_debug_mesh("cpu").shape["data"] == 1
    # three cards, seen through torch.cuda: the runtime's card first,
    # then the others in index order, capped by num_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert MESH.make_cohort_mesh(0, "cuda:1").devices == (
        cuda[1], cuda[0], cuda[2])
    assert MESH.make_cohort_mesh(2, "cuda").devices == (cuda[0], cuda[1])
    assert MESH.make_cohort_mesh(1, "cuda:2").devices == (cuda[2],)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert MESH.make_cohort_mesh(0, "cuda").devices == (cuda[0],)


# ----------------------------------------------------------------------
# the engine: a split changes no client's arithmetic
# ----------------------------------------------------------------------

def test_split_changes_no_clients_arithmetic(data):
    """CNN-FMNIST's batch norm takes each client's own statistics, so
    splitting the client axis (two clients, one a shard) gives the
    unsplit aggregate up to the reassociation of its float32 sum."""
    train, clients, _ = data
    cfg = FLConfig(**dict(KW, local_epochs=1))
    adapter = cnn_adapter("fmnist", "cpu")
    params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in j_adapter("fmnist").init(
            jax.random.PRNGKey(0)).items()}, "cpu")
    assert any("bn" in k for k in params)
    # two clients of one bucket: one a shard
    pair = next(b.client_idx[:2] for b in TCO.pack_cohort(
        train.x, train.y, clients, np.arange(N), np.zeros(N, int), cfg)
        if (b.client_idx >= 0).sum() >= 2)
    buckets = TCO.pack_cohort(train.x, train.y, clients, pair,
                              np.zeros(N, int), cfg, client_multiple=2)
    assert [b.num_clients for b in buckets] == [2]
    want = CohortEngine(adapter, cfg).train_cohort(params, buckets)
    got = CohortEngine(adapter, cfg, mesh=MESH.CohortMesh(
        (CPU, CPU))).train_cohort(params, buckets)
    assert _max_diff(interop.params_to_numpy(got),
                     interop.params_to_numpy(want)) < 1e-6


def test_float32_partials_add_before_the_cast():
    """The shards' float32 partials add on the first device before the
    one cast to the params' dtype (JAX's ``psum(p).astype``), which for
    bf16 params differs from adding partials cast one by one."""
    eng = CohortEngine(cnn_adapter("mnist", "cpu"), FLConfig(**KW),
                       mesh=MESH.CohortMesh(MESHES["8"]))
    g = torch.Generator().manual_seed(0)
    partials = [{"w": torch.rand(64, generator=g) / 8} for _ in range(8)]
    like = {"w": torch.zeros(64, dtype=torch.bfloat16)}
    got = eng._mesh_reduce(partials, like)["w"]
    total = partials[0]["w"]
    for p in partials[1:]:
        total = total + p["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, total.to(torch.bfloat16))
    each = partials[0]["w"].to(torch.bfloat16)
    for p in partials[1:]:
        each = each + p["w"].to(torch.bfloat16)
    assert not torch.equal(each, got)


# ----------------------------------------------------------------------
# the whole loop on a forced mesh, against the JAX package
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vectorized(data):
    train, clients, test_batch = data
    srv = JServer(JConfig(**dict(FORCED, runtime="vectorized")),
                  j_adapter("mnist"), train.x, train.y, clients,
                  test_batch)
    logs = srv.run()
    return logs, {k: np.asarray(v) for k, v in srv.params.items()}


@pytest.fixture(scope="module")
def port_vectorized(data):
    srv = _server(data, **dict(FORCED, runtime="vectorized"))
    logs = srv.run()
    return logs, interop.params_to_numpy(srv.params)


@pytest.mark.parametrize("runtime,mesh", [("sharded", "1"),
                                          ("sharded", "8"),
                                          ("device", "8")])
def test_forced_mesh_matches_jax_vectorized(data, jax_vectorized,
                                            port_vectorized, monkeypatch,
                                            runtime, mesh):
    _force_mesh(monkeypatch, MESHES[mesh])
    srv = _server(data, **dict(FORCED, runtime=runtime))
    assert srv.runtime.name == runtime
    assert srv.runtime.engine.data_axis_size == len(MESHES[mesh])
    if runtime == "device":
        for c in srv.runtime.store.classes:
            assert all(t % 8 == 0 for t in c.tiers), c.tiers
    logs = srv.run()
    j_logs, j_params = jax_vectorized
    assert len(logs) == len(j_logs) == FORCED["rounds"]
    for a, b in zip(j_logs, logs):
        np.testing.assert_array_equal(b.selected, a.selected)
        assert b.energy_std == a.energy_std
        assert b.mean_bid == a.mean_bid
    got = interop.params_to_numpy(srv.params)
    assert _max_diff(j_params, got) < TOL
    assert _max_diff(port_vectorized[1], got) < TOL


# ----------------------------------------------------------------------
# the defended path and fleet dynamics on sharded
# ----------------------------------------------------------------------

ROBUST = dict(KW, rounds=3, local_epochs=1, adversary_frac=0.3,
              attack="scale", defense="trimmed")


def test_defended_sharded_takes_vectorized_verdicts(data, monkeypatch):
    """The defended updates run unsplit on every runtime (the screened
    reduction is one device's), so ``sharded`` on the 8-way mesh gives
    ``vectorized``'s verdicts and params bit for bit."""
    vec = _server(data, **dict(ROBUST, runtime="vectorized"))
    v_logs = vec.run()
    _force_mesh(monkeypatch, MESHES["8"])
    sh = _server(data, **dict(ROBUST, runtime="sharded"))
    assert sh.defended and sh.runtime.engine.data_axis_size == 8
    s_logs = sh.run()
    assert [l.selected.tolist() for l in s_logs] == \
        [l.selected.tolist() for l in v_logs]
    assert sh.defense_totals == vec.defense_totals
    assert torch.equal(sh.state.strikes, vec.state.strikes)
    for k in vec.params:
        assert torch.equal(sh.params[k], vec.params[k]), k


def test_churn_on_sharded_gives_vectorized_outcomes(data, monkeypatch):
    faulty = dict(KW, churn=0.3, deadline=1.5, aggregation="buffered",
                  buffer_goal=2)
    vec = _server(data, **dict(faulty, runtime="vectorized"))
    v_logs = vec.run()
    _force_mesh(monkeypatch, MESHES["8"])
    sh = _server(data, **dict(faulty, runtime="sharded"))
    s_logs = sh.run()
    assert [o.tolist() for o in sh.outcome_log] == \
        [o.tolist() for o in vec.outcome_log]
    assert [l.selected.tolist() for l in s_logs] == \
        [l.selected.tolist() for l in v_logs]
    assert _max_diff(interop.params_to_numpy(vec.params),
                     interop.params_to_numpy(sh.params)) < TOL


# ----------------------------------------------------------------------
# the padding counters, through both CLIs
# ----------------------------------------------------------------------

CLI = ["--clients", "12", "--clusters", "3", "--rounds", "2", "--pool",
       "1200", "--quiet", "--scheme", "random"]


def _pack_counters(path):
    rows = [json.loads(line) for line in open(path)]
    return [(r["name"], r["value"]) for r in rows
            if r["kind"] == "counter" and r["name"].startswith("pack/")]


def test_pack_counters_match_jax_cli(tmp_path, monkeypatch):
    """``--log-jsonl``'s ``pack/*`` counter rows: the port's ``sharded``
    (a 1-device mesh on the CPU) writes the JAX CLI's ``vectorized``
    rows."""
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    monkeypatch.setattr("sys.argv", ["train", *CLI, "--runtime",
                                     "vectorized", "--log-jsonl",
                                     str(jpath)])
    JTRAIN.main()
    TRAIN.main(["--device", "cpu", *CLI, "--runtime", "sharded",
                "--log-jsonl", str(tpath)])
    want = _pack_counters(jpath)
    assert {n for n, _ in want} == {"pack/buckets", "pack/client_rows",
                                    "pack/real_clients"}
    assert _pack_counters(tpath) == want
