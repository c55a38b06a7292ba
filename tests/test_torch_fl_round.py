"""The port's FL round step and FedAvg (``launch/steps.py``) against the
JAX package's, and the constraint helpers (``sharding/constrain.py``)
outside a mesh.

``make_fl_round_step`` runs at qwen2-0.5b's smoke config in float32:
two cohorts with different parameters, two local steps each over a
2 x 32 token micro-batch, then one FedAvg; the port's loop over cohorts
is held to ``jax.jit(make_fl_round_step(...))`` on the same numpy
inputs within 1e-5 (float32 sums in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.launch.steps import fl_aggregate as j_fl_aggregate
from repro.launch.steps import make_fl_round_step as j_make_fl_round_step
from repro.models import model as JMD
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.launch.steps import fl_aggregate, make_fl_round_step
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD
from repro_torch.sharding import constrain as C

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
CPU = torch.device("cpu")
N_COHORTS, LOCAL_STEPS, B, S = 2, 2, 2, 32
LR = 0.05


def _cfgs():
    kw = dict(dtype="float32", remat=False)
    return (JREG.get_smoke_config(ARCH).replace(**kw),
            TREG.get_smoke_config(ARCH).replace(**kw))


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg_j, _ = _cfgs()
    trees = [JMD.init_params(cfg_j, jax.random.PRNGKey(c))
             for c in range(N_COHORTS)]
    params = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *trees)
    rng = np.random.default_rng(7)
    shape = (N_COHORTS, LOCAL_STEPS, B, S)
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, shape, np.int32),
             "labels": rng.integers(0, cfg_j.vocab_size, shape, np.int32),
             "mask": (rng.random(shape) < 0.9).astype(np.float32)}
    return params, batch


@functools.lru_cache(maxsize=None)
def _jax_round():
    cfg_j, _ = _cfgs()
    params, batch = _inputs()
    step = jax.jit(j_make_fl_round_step(cfg_j, lr=LR,
                                        local_steps=LOCAL_STEPS,
                                        n_cohorts=N_COHORTS))
    out, loss = step(jax.tree.map(jnp.asarray, params),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, out), float(loss)


def _port_round():
    _, cfg_t = _cfgs()
    params, batch = _inputs()
    step = make_fl_round_step(cfg_t, lr=LR, local_steps=LOCAL_STEPS,
                              n_cohorts=N_COHORTS)
    out, loss = step(interop.model_params_from_numpy(params, cfg_t, CPU),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    return interop.model_params_to_numpy(out), float(loss)


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_fl_round_matches_jax():
    want, want_loss = _jax_round()
    got, got_loss = _port_round()
    want, got = _flat(want), _flat(got)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(got_loss - want_loss) <= 1e-5
    assert np.isfinite(got_loss)


def test_fl_round_ends_with_equal_cohorts_that_moved():
    got, _ = _port_round()
    start, _ = _inputs()
    moved = False
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v[0], v[1], err_msg=k)
        moved |= not np.array_equal(v, _flat(start)[k])
    assert moved


@pytest.mark.parametrize("weights", [[1.0, 1.0], [3.0, 1.0], [0.2, 0.5, 2.0]])
def test_fl_aggregate_matches_jax(weights):
    rng = np.random.default_rng(3)
    n = len(weights)
    tree = {"a": rng.normal(size=(n, 5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 11)).astype(np.float32)}}
    w = np.asarray(weights, np.float32)
    want = j_fl_aggregate(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    got = fl_aggregate({"a": torch.from_numpy(tree["a"]),
                        "b": {"c": torch.from_numpy(tree["b"]["c"])}},
                       torch.from_numpy(w))
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=0, atol=1e-6)
    flat = fl_aggregate({"x.y": torch.from_numpy(tree["a"])},
                        torch.from_numpy(w))
    np.testing.assert_array_equal(flat["x.y"].numpy(), got["a"].numpy())


def test_maybe_constrain_outside_a_mesh_returns_its_argument():
    assert C.current_mesh() is None
    x = torch.randn(4, 6, 8)
    assert C.maybe_constrain(x, "data", None, "model") is x
    assert C.maybe_constrain(x, ("pod", "data")) is x
    y = C.split_last(x, 2, 4)
    assert y.shape == (4, 6, 2, 4) and torch.equal(y, x.reshape(4, 6, 2, 4))
    assert torch.equal(C.merge_last(y), x)
    logits = torch.randn(3, 5, 11)
    idx = torch.randint(0, 11, (3, 5, 1))
    assert torch.equal(TL._logsumexp(logits), torch.logsumexp(logits, -1))
    assert torch.equal(TL._softmax_minus_onehot(logits, idx),
                       torch.softmax(logits, -1)
                       - torch.zeros_like(logits).scatter(-1, idx, 1.0))


def test_forbid_axes_nests_and_restores():
    def forbidden():
        return getattr(C._STATE, "forbidden", frozenset())

    assert forbidden() == frozenset()
    with C.forbid_axes("pod"):
        assert forbidden() == {"pod"}
        with C.forbid_axes("data", "model"):
            assert forbidden() == {"pod", "data", "model"}
        assert forbidden() == {"pod"}
        with pytest.raises(RuntimeError):
            with C.forbid_axes("model"):
                raise RuntimeError
        assert forbidden() == {"pod"}
    assert forbidden() == frozenset()


def test_filter_entry_keeps_mesh_axes():
    axes = {"data", "model"}
    assert C._filter_entry(axes, None) is None
    assert C._filter_entry(axes, ("pod", "data")) == "data"
    assert C._filter_entry(axes, ("pod",)) is None
    assert C._filter_entry({"pod", "data"}, ("pod", "data")) == \
        ("pod", "data")
    assert C._filter_entry(axes, "model") == "model"
    assert C._filter_entry(axes, "pod") is None


def test_value_and_grad_gives_zeros_to_unused_leaves():
    """As jax.grad: a leaf the loss does not read gets a zero gradient."""
    flat = {"a": torch.ones(3), "b": torch.ones(2)}
    value, grads = TMD.value_and_grad(lambda f, b: (f["a"] * b).sum(), flat,
                                      torch.arange(3.0))
    assert float(value) == 3.0
    assert torch.equal(grads["a"], torch.arange(3.0))
    assert torch.equal(grads["b"], torch.zeros(2))


# the dry run's FL round at one 24-token sequence a device: the 2 x 2 x
# 2 (pod, data, model) mesh, 2 cohorts x 2 local steps x 2 sequences
ONE_SEQ = """
import json, torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_mesh
import torch.distributed as dist
cfg = get_smoke_config("qwen2-0.5b").replace(remat=False)
m = fake_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
rec = DR.dryrun_one("qwen2-0.5b", "small", True, device="cpu", mesh=m,
                    cfg=cfg, shape=ShapeConfig("small", 24, 4, "train"),
                    fl_local_steps=2)
dist.destroy_process_group()
print("RECORD " + json.dumps(rec))
"""


def test_dryrun_fl_round_at_one_sequence_a_device():
    """The vocab-sharded lookup's masked partial sums meet a plain partial
    gradient in the backward at one sequence a device: the record is
    ``ok``, and its cross-pod bytes are exactly the float32 FedAvg of the
    device's parameter shard (JAX's sanitized specs on 'data' x 'model')."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from jax.sharding import PartitionSpec as P

    from repro.launch import specs as JSP
    from repro.sharding import rules as JR

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", ONE_SEQ], capture_output=True,
                       text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    line = next(l for l in p.stdout.splitlines() if l.startswith("RECORD "))
    rec = json.loads(line[len("RECORD "):])
    assert rec["status"] == "ok" and rec["fl_local_steps"] == 2
    cfg = JREG.get_smoke_config(ARCH)
    axes = {"data": 2, "model": 2}
    pshape = JSP.params_shape(cfg)
    specs = JR.sanitize_specs(JR.param_specs(cfg, pshape), pshape, axes)
    shard = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(pshape),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(x, P))):
        n = int(np.prod(leaf.shape))
        for e in spec:
            n //= JR._n_shards(e, axes)
        shard += n
    assert rec["collectives"]["cross_pod"] == 4 * shard
