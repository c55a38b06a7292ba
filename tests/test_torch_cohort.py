"""The port's host-side packers against the JAX package's, bit for bit:
``pack_cohort``, ``pack_feature_pass``, ``HostPlanCache.plan`` and
``FleetStore`` (capacity classes, tiers, the resident class tensors,
``assemble`` and ``warmup_batches``) at tests/test_sim.py's size (N=10,
pool 700, J=3, select_ratio 0.4, 2 local epochs, seed 3)."""
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.data.partition import ClientData, partition_clients
from repro.data.synthetic import make_image_dataset
from repro.sim import cohort as JCO
from repro.sim import fleet as JFL
from repro_torch.configs.base import FLConfig
from repro_torch.sim import cohort as TCO
from repro_torch.sim import fleet as TFL

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

N = 10
KW = dict(num_clients=N, num_clusters=3, select_ratio=0.4, rounds=2,
          local_epochs=2, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)

SELECTIONS = {"all": np.arange(N), "three": np.array([7, 0, 3]),
              "one": np.array([2]), "none": np.array([], np.int64)}
CONFIGS = {"default": {}, "width1": {"cohort_vmap_width": 1},
           "width8_epoch1": {"cohort_vmap_width": 8, "local_epochs": 1},
           "ratio0.9": {"select_ratio": 0.9}}


@pytest.fixture(scope="module")
def data():
    train, _ = make_image_dataset("mnist", n_train=700, n_test=120, seed=3)
    clients = partition_clients(train.y, JConfig(**KW), seed=3)
    return train, clients


def _zero_size_client() -> ClientData:
    e = np.empty((0,), np.int64)
    return ClientData(train_idx=e, val_idx=e, test_idx=e, primary_label=0)


def _assert_same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_buckets(jb, tb):
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        assert j.batch_size == t.batch_size
        for f in ("client_idx", "xb", "yb", "step_mask", "weights"):
            _assert_same_arrays(getattr(j, f), getattr(t, f), f)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("sel_name", sorted(SELECTIONS))
def test_pack_cohort_bit_identical(data, cfg_name, sel_name):
    train, clients = data
    kw = dict(KW, **CONFIGS[cfg_name])
    sel, hist = SELECTIONS[sel_name], np.arange(N) % 3
    jb = JCO.pack_cohort(train.x, train.y, clients, sel, hist, JConfig(**kw))
    tb = TCO.pack_cohort(train.x, train.y, clients, sel, hist,
                         FLConfig(**kw))
    _assert_same_buckets(jb, tb)
    assert (len(tb) == 0) == (sel.size == 0)


def test_pack_cohort_drops_zero_size_winner(data):
    train, clients = data
    clients = list(clients)[:4] + [_zero_size_client()]
    sel, hist = np.arange(5), np.zeros(5, np.int64)
    jb = JCO.pack_cohort(train.x, train.y, clients, sel, hist,
                         JConfig(**KW))
    tb = TCO.pack_cohort(train.x, train.y, clients, sel, hist,
                         FLConfig(**KW))
    _assert_same_buckets(jb, tb)
    assert 4 not in np.concatenate([b.client_idx for b in tb])
    assert TCO.pack_cohort(train.x, train.y, [_zero_size_client()] * 3,
                           np.arange(3), np.zeros(3), FLConfig(**KW)) == []


@pytest.mark.parametrize("width", [1, 4, 8])
def test_pack_feature_pass_bit_identical(data, width):
    train, clients = data
    _assert_same_buckets(
        JCO.pack_feature_pass(train.x, train.y, clients, chunk_width=width),
        TCO.pack_feature_pass(train.x, train.y, clients, chunk_width=width))


@pytest.mark.parametrize("epochs", [1, 2])
def test_plan_cache_bit_identical(data, epochs):
    train, clients = data
    jc = JCO.HostPlanCache(train.x, train.y, clients, epochs)
    tc = TCO.HostPlanCache(train.x, train.y, clients, epochs)
    for f in ("sizes", "bs", "steps"):
        _assert_same_arrays(getattr(jc, f), getattr(tc, f), f)
    for i in range(N):
        for hist in (0, 1, 5):
            plan = tc.plan(i, hist)
            _assert_same_arrays(jc.plan(i, hist), plan, f"plan {i} {hist}")
            # the local plan composes with the shard to the oracle's plan
            n = clients[i].size
            ref = TCO.oracle_batch_plan(n, min(32, n), epochs,
                                        np.random.default_rng(hist * 977 + i))
            np.testing.assert_array_equal(tc.shards[i][plan],
                                          tc.shards[i][ref])
        for j, t in zip(jc.local_data(i), tc.local_data(i)):
            _assert_same_arrays(j, t, f"local data {i}")


def _assert_same_class_batches(jb, tb):
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        assert j.cls_id == t.cls_id
        for f in ("rows", "plans", "step_mask", "weights", "client_idx"):
            _assert_same_arrays(getattr(j, f), getattr(t, f), f)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_fleet_store_bit_identical(data, cfg_name):
    train, clients = data
    kw = dict(KW, **CONFIGS[cfg_name])
    js = JFL.FleetStore(train.x, train.y, clients, JConfig(**kw))
    ts = TFL.FleetStore(train.x, train.y, clients, FLConfig(**kw),
                        device="cpu")
    _assert_same_arrays(js.class_of, ts.class_of, "class_of")
    _assert_same_arrays(js.row_of, ts.row_of, "row_of")
    assert len(js.classes) == len(ts.classes) > 1
    for j, t in zip(js.classes, ts.classes):
        assert (j.bs, j.step_cap, j.tiers, j.n_cap, j.client_cap) == \
            (t.bs, t.step_cap, t.tiers, t.n_cap, t.client_cap)
        _assert_same_arrays(j.members, t.members, "members")
        assert t.x.device.type == "cpu"
        _assert_same_arrays(j.x, t.x.numpy(), "class x")
        _assert_same_arrays(j.y, t.y.numpy(), "class y")
    _assert_same_class_batches(js.warmup_batches(), ts.warmup_batches())
    hist = np.arange(N) % 3
    for sel in SELECTIONS.values():
        _assert_same_class_batches(js.assemble(sel, hist),
                                   ts.assemble(sel, hist))


def test_fleet_store_skips_zero_size_clients(data):
    train, clients = data
    clients = list(clients)[:4] + [_zero_size_client()]
    kw = dict(KW, num_clients=5)
    js = JFL.FleetStore(train.x, train.y, clients, JConfig(**kw))
    ts = TFL.FleetStore(train.x, train.y, clients, FLConfig(**kw),
                        device="cpu")
    assert ts.class_of[4] == -1
    _assert_same_arrays(js.class_of, ts.class_of, "class_of")
    hist = np.zeros(5, np.int64)
    _assert_same_class_batches(js.assemble(np.arange(5), hist),
                               ts.assemble(np.arange(5), hist))
    assert ts.assemble(np.array([4]), hist) == []
