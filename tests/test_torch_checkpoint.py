"""The port's checkpoints (repro_torch.checkpoint.io and the server's
save/resume path) against the JAX package's: the io guards of
tests/test_checkpoint.py (roundtrip, duplicate key, treedef drift, key
set, truncation, bit rot, garbage manifest, digest-less manifest, no temp
files), the server tree's key strings equal to the JAX server's, a JAX
checkpoint resumed by the port (rounds 2-3 select the JAX run's clients,
params within 1e-4), a port checkpoint restored by the JAX package,
bit-exact resume with and without dynamics and under longterm_auction,
the scheme-mismatch refusal, and nothing written with checkpoints off.
Fixtures at tests/test_checkpoint.py's size (N=10, pool 700, J=3,
4 rounds, seed 3)."""
import json
import os

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
from repro_torch import obs
from repro_torch.checkpoint import io as CKPT
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.selection import SelectionState
from repro_torch.core.server import FederatedServer

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=4,
          local_epochs=1, sample_window=10, cluster_resamples=2,
          init_energy_mode="normal", seed=3)
DYN = dict(churn=0.2, deadline=1.1)


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


# ----------------------------------------------------------------------
# io-level guards
# ----------------------------------------------------------------------

def test_roundtrip_preserves_values_step_and_dtypes(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"inner": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "s": torch.tensor(2.5), "n": np.int32(4),
            "h": torch.tensor([0.5, -2.0], dtype=torch.bfloat16),
            "k": np.array([7, 2 ** 32 - 1], np.uint32)}
    path = str(tmp_path / "ck")
    CKPT.save(path, tree, step=7, extra={"note": 1})
    with np.load(path + ".npz") as raw:
        assert raw["h"].dtype == np.float32      # bf16 stored as float32
        assert raw["k"].dtype == np.uint32
    out, step = CKPT.restore(path, tree)
    assert step == 7
    for k in ("w", "h"):
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k],
                                                              tree[k])
    assert out["s"].shape == () and float(out["s"]) == 2.5
    assert out["n"].shape == () and out["n"].dtype == np.int32
    assert out["b"]["inner"].dtype == torch.int32
    assert torch.equal(out["b"]["inner"], tree["b"]["inner"])
    np.testing.assert_array_equal(out["k"], tree["k"])
    with open(path + ".json") as f:
        manifest = json.load(f)
    assert manifest["extra"] == {"note": 1}
    assert manifest["keys"] == ["b/inner", "h", "k", "n", "s", "w"]


def test_dataclass_fields_flatten_to_the_jax_key_strings(tmp_path):
    state = SelectionState(clusters=torch.zeros(3, dtype=torch.int32),
                           residual=torch.ones(3),
                           history=torch.zeros(3, dtype=torch.int32),
                           local_sizes=torch.ones(3, dtype=torch.int32))
    assert list(CKPT._flatten({"state": state})) == [
        "state/.clusters", "state/.residual", "state/.history",
        "state/.local_sizes"]
    path = str(tmp_path / "ds")
    CKPT.save(path, {"state": state, "seq": [torch.ones(2)]})
    out, _ = CKPT.restore(path, {"state": state, "seq": [torch.ones(2)]})
    assert isinstance(out["state"], SelectionState)
    assert out["state"].staleness is None
    assert torch.equal(out["state"].residual, state.residual)


def test_duplicate_flattened_key_raises(tmp_path):
    tree = {"a": {"b": np.zeros(2)}, "a/b": np.ones(2)}
    with pytest.raises(ValueError, match="duplicate flattened"):
        CKPT.save(str(tmp_path / "dup"), tree)


def test_treedef_drift_warns_but_restores_by_key(tmp_path):
    path = str(tmp_path / "drift")
    CKPT.save(path, {"a": [torch.arange(3.0)]})       # list container
    like = {"a": (torch.zeros(3),)}                   # same keys, tuple
    with pytest.warns(UserWarning, match="treedef mismatch"):
        out, _ = CKPT.restore(path, like)
    assert isinstance(out["a"], tuple)
    assert torch.equal(out["a"][0], torch.arange(3.0))


def test_key_set_mismatch_asserts(tmp_path):
    path = str(tmp_path / "keys")
    CKPT.save(path, {"a": torch.zeros(2)})
    with pytest.raises(AssertionError, match="keys mismatch"):
        CKPT.restore(path, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_truncated_snapshot_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "trunc")
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    CKPT.save(path, tree)
    size = os.path.getsize(path + ".npz")
    with open(path + ".npz", "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(CKPT.CheckpointCorrupt, match="integrity"):
        CKPT.restore(path, tree)


def test_bitrot_snapshot_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "rot")
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    CKPT.save(path, tree)
    with open(path + ".npz", "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(CKPT.CheckpointCorrupt, match="integrity"):
        CKPT.restore(path, tree)


def test_unreadable_npz_without_digest_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "junk")
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    CKPT.save(path, tree)
    with open(path + ".json") as f:
        manifest = json.load(f)
    del manifest["digest"]
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    with open(path + ".npz", "wb") as f:
        f.write(b"not a zip file")
    with pytest.raises(CKPT.CheckpointCorrupt, match="unreadable"):
        CKPT.restore(path, tree)


def test_garbage_manifest_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "badjson")
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    CKPT.save(path, tree)
    with open(path + ".json", "w") as f:
        f.write("{not json")
    with pytest.raises(CKPT.CheckpointCorrupt, match="manifest"):
        CKPT.restore(path, tree)


def test_digestless_manifest_still_restores(tmp_path):
    path = str(tmp_path / "legacy")
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    CKPT.save(path, tree)
    with open(path + ".json") as f:
        manifest = json.load(f)
    del manifest["digest"]
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    out, _ = CKPT.restore(path, tree)
    assert torch.equal(out["w"], tree["w"])


def test_save_leaves_no_tmp_files(tmp_path):
    CKPT.save(str(tmp_path / "atomic"), {"w": torch.zeros(3)})
    assert sorted(os.listdir(tmp_path)) == ["atomic.json", "atomic.npz"]


# ----------------------------------------------------------------------
# the server tree against the JAX server's
# ----------------------------------------------------------------------

CASES = {"plain": {}, "dynamics": DYN,
         "longterm-dynamics": dict(DYN, scheme_select="longterm_auction")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ckpt_tree_keys_equal_the_jax_servers(data, case):
    t = CKPT._flatten(_server(data, **CASES[case])._ckpt_tree())
    j = JCKPT._flatten(_jserver(data, **CASES[case])._ckpt_tree())
    assert list(t) == list(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k


@pytest.mark.parametrize("case", ["plain", "dynamics"])
def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, case):
    kw = CASES[case]
    ref = _jserver(data, **kw)
    ref_logs = ref.run(rounds=4)
    path = str(tmp_path / "jax_ck")
    _jserver(data, **kw).run(rounds=3, checkpoint_every=2,
                             checkpoint_path=path)
    srv = _server(data, **kw)
    with pytest.warns(UserWarning, match="treedef mismatch"):
        logs = srv.run(rounds=4, checkpoint_path=path, resume=True)
    assert [l.round for l in logs] == [2, 3]
    for a, b in zip(ref_logs[2:], logs):
        np.testing.assert_array_equal(a.selected, b.selected)
    if kw:
        assert [o.tolist() for o in srv.outcome_log] == \
            [o.tolist() for o in ref.outcome_log[2:]]
    for k, v in ref.params.items():
        np.testing.assert_allclose(srv.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(srv._host_history, ref._host_history)
    assert srv.total_client_reward == pytest.approx(
        ref.total_client_reward, rel=1e-5)


def test_port_checkpoint_restores_in_the_jax_package(data, tmp_path):
    path = str(tmp_path / "port_ck")
    srv = _server(data, **DYN)
    srv.run(rounds=3, checkpoint_every=2, checkpoint_path=path)
    jsrv = _jserver(data, **DYN)
    with pytest.warns(UserWarning, match="treedef mismatch"):
        step = jsrv.load_checkpoint(path)
    assert step == 2
    mid = _server(data, **DYN)
    mid.run(rounds=2)
    for k, v in mid.params.items():
        np.testing.assert_array_equal(np.asarray(jsrv.params[k]), v.numpy())
    np.testing.assert_array_equal(np.asarray(jsrv.key), mid.key.numpy())
    np.testing.assert_array_equal(np.asarray(jsrv.dyn_state.avail),
                                  mid.dyn_state.avail.numpy())


# ----------------------------------------------------------------------
# server crash/resume
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_bit_exact_vs_uninterrupted(data, tmp_path, case):
    kw = CASES[case]
    ref = _server(data, **kw)
    logs_ref = ref.run(rounds=4)
    path = str(tmp_path / "resume_ck")
    # "crash" after round 2: checkpoint_every=2 saves at the t=1 boundary
    _server(data, **kw).run(rounds=3, checkpoint_every=2,
                            checkpoint_path=path)
    resumed = _server(data, **kw)
    logs_res = resumed.run(rounds=4, checkpoint_path=path, resume=True)
    assert [l.round for l in logs_res] == [2, 3]
    _assert_params_equal(ref.params, resumed.params)
    for a, b in zip(logs_ref[2:], logs_res):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.mean_bid == b.mean_bid and a.energy_std == b.energy_std
        assert a.test_acc == b.test_acc
    np.testing.assert_array_equal(ref._host_history, resumed._host_history)
    assert ref.total_client_reward == resumed.total_client_reward
    assert torch.equal(ref.state.residual, resumed.state.residual)
    if kw:
        assert torch.equal(ref.dyn_state.avail, resumed.dyn_state.avail)
        assert torch.equal(ref.state.staleness, resumed.state.staleness)
        assert [o.tolist() for o in ref.outcome_log[2:]] == \
            [o.tolist() for o in resumed.outcome_log]
    if "scheme_select" in kw:
        a, b = ref.state.scheme_state, resumed.state.scheme_state
        for f in ("spent", "queue", "paid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_resume_scheme_mismatch_raises(data, tmp_path):
    path = str(tmp_path / "mismatch_ck")
    _server(data).run(rounds=3, checkpoint_every=2, checkpoint_path=path)
    other = _server(data, scheme_select="longterm_auction")
    with pytest.raises(ValueError, match="--scheme-select"):
        other.run(rounds=4, checkpoint_path=path, resume=True)


def test_no_checkpoint_written_when_disabled(data, tmp_path):
    path = str(tmp_path / "never")
    _server(data).run(rounds=2, checkpoint_path=path)   # checkpoint_every=0
    assert not os.path.exists(path + ".npz")
    assert os.listdir(tmp_path) == []


def test_cli_checkpoint_and_resume(tmp_path):
    from repro_torch.launch import train as TRAIN
    path = str(tmp_path / "cli_ck")
    # synchronous aggregation: a buffered run loses the late updates in
    # flight at the snapshot (FedBuff's restart semantics), by design
    argv = ["--device", "cpu", "--clients", "12", "--clusters", "3",
            "--pool", "1200", "--quiet", "--churn", "0.2", "--deadline",
            "1.2"]
    full = TRAIN.main(argv + ["--rounds", "4"])
    TRAIN.main(argv + ["--rounds", "3", "--checkpoint-every", "2",
                       "--checkpoint-path", path])
    tail = TRAIN.main(argv + ["--rounds", "4", "--checkpoint-path", path,
                              "--resume"])
    assert tail["rounds"] == [2, 3]
    assert tail["selected"] == full["selected"][2:]
    assert tail["test_loss"] == full["test_loss"][2:]
