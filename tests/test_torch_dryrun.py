"""The port's dry run (``launch/dryrun.py``) on small fake meshes: qwen2-0.5b's
smoke config through the train step on a 2 x 2 (data, model) mesh and
on a 2 x 2 x 2 (pod, data, model) mesh, and through the FL round on the
latter.  Each runs in a subprocess of its own, side by side, so the fake
process group never meets another test.
The records are held to the JAX package: their keys, ``n_params`` and
``model_flops`` from its parameter counts, the argument bytes from its
sanitized specs, no cross-pod bytes without 'pod', with the two-pod
train step exactly ``_pod_mean``'s all-reduce of each parameter's local
shard in the gradient's type, and with the FL round exactly the
FedAvg's all-reduce of the device's parameter shard in float32.  The port's forward on plain tensors, with the constraint
points in place, is held to JAX's at test_torch_transformer.py's bound.
Importing the dry run starts no process group and loads no JAX."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as JREG
from repro.launch import roofline as JRL
from repro.launch import specs as JSP
from repro.models import model as JMD
from repro.sharding import rules as JR
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.models import model as TMD

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
B, S = 4, 32

RUN = f"""
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_mesh
import torch.distributed as dist
cfg = get_smoke_config("{ARCH}").replace(remat=False)
shape = ShapeConfig("small", {S}, {B}, "train")
if sys.argv[1] == "pod1":
    m = fake_mesh((2, 2), ("data", "model"), "cpu")
    rec = DR.dryrun_one("{ARCH}", "small", False, device="cpu", mesh=m,
                        cfg=cfg, shape=shape)
    rec["headline"] = DR.headline(rec)
elif sys.argv[1] == "pod2":
    m = fake_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    rec = DR.dryrun_one("{ARCH}", "small", True, device="cpu", mesh=m,
                        cfg=cfg, shape=shape)
else:
    m = fake_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert dist.get_world_size() == 8
    rec = DR.dryrun_one("{ARCH}", "small", True, device="cpu", mesh=m,
                        cfg=cfg, shape=shape, fl_local_steps=2)
dist.destroy_process_group()
print("RECORD " + json.dumps(rec))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def records():
    """The one-pod and two-pod train steps and the two-pod FL round, each
    in a process of its own (run side by side)."""
    procs = {k: subprocess.Popen([sys.executable, "-c", RUN, k],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=_env())
             for k in ("pod1", "pod2", "fl")}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
        line = next(l for l in stdout.splitlines()
                    if l.startswith("RECORD "))
        out[k] = json.loads(line[len("RECORD "):])
    out["headline"] = out["pod1"].pop("headline")
    return out


def _jax_local_bytes(axes, multi_pod=False):
    """Bytes of one device's parameter shards (by JAX's sanitized specs)
    and of its batch shards."""
    cfg = JREG.get_smoke_config(ARCH)
    pshape = JSP.params_shape(cfg)
    specs = JR.sanitize_specs(JR.param_specs(cfg, pshape), pshape, axes)
    leaves = jax.tree_util.tree_leaves(pshape)
    sleaves = jax.tree_util.tree_leaves(specs,
                                        is_leaf=lambda x: isinstance(x, P))
    n_local = []
    for leaf, spec in zip(leaves, sleaves):
        n = int(np.prod(leaf.shape))
        for e in spec:
            n //= JR._n_shards(e, axes)
        n_local.append((n, leaf.dtype.itemsize))
    batch = 3 * (B // JR._n_shards(JR.batch_axis(multi_pod), axes)) * S * 4
    return n_local, batch


KEYS = {"arch", "shape", "mesh", "kind", "kv_dtype", "fsdp_gather", "status",
        "device", "n_devices", "lower_s", "memory", "cost", "collectives",
        "model_flops", "n_params"}


def test_record_keys(records):
    rec = records["pod1"]
    assert set(rec) == KEYS
    assert set(records["fl"]) == KEYS | {"fl_local_steps"}
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    assert records["fl"]["n_devices"] == 8
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert set(rec["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "count", "total", "cross_pod"}
    assert rec["collectives"]["count"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"))
    assert rec["cost"]["flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    assert "fake run ok" in records["headline"]


def test_params_and_model_flops_match_jax(records):
    total, active, embed = JRL._param_counts(JREG.get_smoke_config(ARCH))
    for rec in records.values():
        if isinstance(rec, dict):
            assert rec["n_params"] == total
            assert rec["model_flops"] == 6.0 * (active + embed) * B * S


def test_argument_bytes_match_jax_specs(records):
    n_local, batch = _jax_local_bytes({"data": 2, "model": 2})
    params = sum(n * size for n, size in n_local)
    mem = records["pod1"]["memory"]
    assert mem["argument_size_in_bytes"] == params + batch
    assert mem["output_size_in_bytes"] >= params


def test_cross_pod_bytes(records):
    assert records["pod1"]["collectives"]["cross_pod"] == 0
    # the FedAvg: one float32 all-reduce of the device's parameter shard
    # (the cohort dim is split over 'pod', the rest as on one pod)
    n_local, _ = _jax_local_bytes({"data": 2, "model": 2})
    fl = records["fl"]["collectives"]
    assert fl["cross_pod"] == 4 * sum(n for n, _ in n_local)
    assert fl["all-reduce"] >= fl["cross_pod"]


def test_pod_mean_moves_each_gradient_shard_once(records):
    """A train step with 'pod': each pod steps on its half of the batch
    (the argument bytes are JAX's on the (pod, data, model) mesh), and
    what crosses pods is ``_pod_mean``'s all-reduce of each parameter's
    local shard in the gradient's type (the parameter's), once."""
    axes = {"pod": 2, "data": 2, "model": 2}
    n_local, batch = _jax_local_bytes(axes, multi_pod=True)
    rec = records["pod2"]
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["memory"]["argument_size_in_bytes"] == \
        sum(n * size for n, size in n_local) + batch
    coll = rec["collectives"]
    assert coll["cross_pod"] == sum(n * size for n, size in n_local)
    assert coll["all-reduce"] >= coll["cross_pod"]


def test_forward_with_constraint_points_matches_jax():
    """Plain tensors (no mesh): the model with its constraint points in
    place gives JAX's logits at test_torch_transformer.py's bound."""
    cfg_j = JREG.get_smoke_config(ARCH).replace(dtype="float32")
    cfg_t = TREG.get_smoke_config(ARCH).replace(dtype="float32")
    params = JMD.init_params(cfg_j, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (2, 40))
    want = np.asarray(JMD.logits_fn(cfg_j, params, jax.numpy.asarray(tokens)))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg_t, "cpu")
    got = TMD.logits_fn(cfg_t, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the zoo on the 2 x 2 mesh: the MoE's token groups where E does not
# divide 'model', and xlstm's train and prefill
# ----------------------------------------------------------------------

CASE = """
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import moe as MOE
import torch.distributed as dist
arch, kind, over, patch = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
seq = int(sys.argv[5]) if len(sys.argv) > 5 else {S}
kw = dict(remat=False)
kw.update(json.loads(over))
cfg = get_smoke_config(arch).replace(**kw)
if patch == "one_group":
    MOE._num_groups = lambda t: 1
if patch == "every_step":
    import contextlib
    DR.tally_loops = lambda hook: contextlib.nullcontext()
if patch == "qkv_gathered":
    # the mLSTM's q, k and v whole over 'model'
    from repro_torch.models import xlstm as X
    mc = X.maybe_constrain
    X.maybe_constrain = lambda t, *a: mc(
        t, *(None if e == "model" else e for e in a))
m = fake_mesh((2, 2), ("data", "model"), "cpu")
rec = DR.dryrun_one(arch, "small", False, device="cpu", mesh=m, cfg=cfg,
                    shape=ShapeConfig("small", seq, {B}, kind))
dist.destroy_process_group()
print("RECORD " + json.dumps(rec))
"""
MOE_ARCH = "granite-moe-3b-a800m"
MOE_OVER = {"num_experts": 3}           # E does not divide 'model' (2)
ZOO_CASES = {
    "moe": (MOE_ARCH, "train", MOE_OVER, "none"),
    "moe_one_group": (MOE_ARCH, "train", MOE_OVER, "one_group"),
    "xlstm_train": ("xlstm-1.3b", "train", {"remat": True}, "none"),
    "xlstm_train_every_step": ("xlstm-1.3b", "train", {"remat": True},
                               "every_step"),
    "xlstm_prefill": ("xlstm-1.3b", "prefill", {}, "none"),
    "xlstm_prefill_every_step": ("xlstm-1.3b", "prefill", {}, "every_step"),
}


# xlstm's mLSTM with v's head_dim split over 'model' (as JAX's) against
# q, k and v gathered there: (kind, overrides, patch, sequence length);
# the split prefill is ZOO_CASES' xlstm_prefill.  The train step runs 128
# tokens, where the mLSTM's chunk holds the peak (at 32 the sLSTM's does)
XLSTM_SPLIT_CASES = {
    "xlstm_train_128": ("train", {"remat": True}, "none", 128),
    "xlstm_train_128_qkv_gathered": ("train", {"remat": True},
                                     "qkv_gathered", 128),
    "xlstm_prefill_qkv_gathered": ("prefill", {}, "qkv_gathered", S),
}


@pytest.fixture(scope="module")
def zoo_records():
    """Each case of ZOO_CASES and XLSTM_SPLIT_CASES in a process of its
    own, side by side."""
    cases = {k: (a, kind, over, patch, S)
             for k, (a, kind, over, patch) in ZOO_CASES.items()}
    cases.update({k: ("xlstm-1.3b", *c)
                  for k, c in XLSTM_SPLIT_CASES.items()})
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", CASE.format(S=S, B=B), a, kind,
         json.dumps(over), patch, str(seq)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
        for k, (a, kind, over, patch, seq) in cases.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
        line = next(l for l in stdout.splitlines()
                    if l.startswith("RECORD "))
        out[k] = json.loads(line[len("RECORD "):])
    return out


def _jax_param_bytes(cfg, axes):
    """Bytes of one device's parameter shards by JAX's sanitized specs."""
    pshape = JSP.params_shape(cfg)
    specs = JR.sanitize_specs(JR.param_specs(cfg, pshape), pshape, axes)
    leaves = jax.tree_util.tree_leaves(pshape)
    sleaves = jax.tree_util.tree_leaves(specs,
                                        is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, sleaves):
        n = int(np.prod(leaf.shape))
        for e in spec:
            n //= JR._n_shards(e, axes)
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("case", sorted(ZOO_CASES))
def test_zoo_records_ok_with_jax_params(zoo_records, case):
    """Every case is ``ok`` with JAX's parameter count and argument bytes
    (parameter and batch shards by JAX's sanitized specs); no cross-pod
    bytes on one pod."""
    arch, kind, over, _ = ZOO_CASES[case]
    rec = zoo_records[case]
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    cfg_j = JREG.get_smoke_config(arch).replace(**over).replace(remat=False)
    assert rec["n_params"] == JRL._param_counts(cfg_j)[0]
    assert rec["collectives"]["cross_pod"] == 0
    assert rec["cost"]["flops"] > 0
    batch = 3 * (B // 2) * S * 4
    assert rec["memory"]["argument_size_in_bytes"] == _jax_param_bytes(
        cfg_j, {"data": 2, "model": 2}) + batch


def test_moe_token_groups_lower_the_temp_bytes(zoo_records):
    """Two token groups (the 'data' axis) against one: each device's
    buffer holds its group's capacity, not the batch's."""
    grouped = zoo_records["moe"]["memory"]["temp_size_in_bytes"]
    one = zoo_records["moe_one_group"]["memory"]["temp_size_in_bytes"]
    assert grouped < one


def test_xlstm_prefill_counts_every_slstm_step(zoo_records):
    """The fake run runs one sLSTM step and counts it S times
    (``constrain.loop_trips``): the FLOPs and collectives are those of
    the run that takes all S steps, and at least the recurrent products
    of S steps (4 gates, B/2 rows, 4 heads of dh x dh)."""
    once, every = (zoo_records[k] for k in ("xlstm_prefill",
                                            "xlstm_prefill_every_step"))
    assert once["cost"] == every["cost"]
    assert once["collectives"] == every["collectives"]
    cfg = TREG.get_smoke_config("xlstm-1.3b")
    h = cfg.xlstm_num_heads
    dh = cfg.d_model // h
    assert once["cost"]["flops"] >= S * 4 * (B // 2) * h * 2 * dh * dh


def test_xlstm_train_counts_every_slstm_step(zoo_records):
    """Through the train step with remat the counted trip's backward is
    counted S times too, and remat's recompute counts its forward: the
    collectives are those of the run that takes all S steps, and the
    FLOPs exceed its by one step's gradient products into the zero
    initial state (the counted trip stands for an inner step)."""
    once, every = (zoo_records[k] for k in ("xlstm_train",
                                            "xlstm_train_every_step"))
    assert once["collectives"] == every["collectives"]
    cfg = TREG.get_smoke_config("xlstm-1.3b")
    h = cfg.xlstm_num_heads
    dh = cfg.d_model // h
    assert once["cost"]["flops"] - every["cost"]["flops"] == \
        4 * (B // 2) * h * 2 * dh * dh


@pytest.mark.parametrize("kind,split,gathered", [
    ("train", "xlstm_train_128", "xlstm_train_128_qkv_gathered"),
    ("prefill", "xlstm_prefill", "xlstm_prefill_qkv_gathered")])
def test_xlstm_head_dim_split_lowers_the_temp_bytes(zoo_records, kind, split,
                                                     gathered):
    """The mLSTM with v's head_dim split over 'model' (dh / 2 columns a
    device: its state C and its output halved) against q, k and v
    gathered there: lower peak bytes a device, the same parameter and
    argument bytes, and fewer FLOPs (the products with v's columns
    halved)."""
    a, b = zoo_records[split], zoo_records[gathered]
    assert a["status"] == b["status"] == "ok"
    assert a["memory"]["temp_size_in_bytes"] < \
        b["memory"]["temp_size_in_bytes"]
    assert a["memory"]["argument_size_in_bytes"] == \
        b["memory"]["argument_size_in_bytes"]
    assert a["cost"]["flops"] < b["cost"]["flops"]


# ----------------------------------------------------------------------
# heads and vocab that the 'model' axis does not divide, padded to it
# ----------------------------------------------------------------------

PADDED = """
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import layers as L
import torch.distributed as dist
name, kind = sys.argv[1], sys.argv[2]
seq, B = int(sys.argv[3]), int(sys.argv[4])
cfg = DR.small_config(name).replace(remat=False)
seen = {"heads": [], "vocab": []}


def local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def heads_of(fn, dim=2):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        for t in out if isinstance(out, tuple) else (out,):
            seen["heads"].append((fn.__name__, local(t).shape[dim]))
        return out
    return wrapped


L._q, L.kv_proj, L.apply_rope = (heads_of(f) for f in
                                 (L._q, L.kv_proj, L.apply_rope))
shards = L.on_local_shards


def on_shards(fn, placements, *args):
    if len(args) == 3:          # an attention's (q, k, v)
        dim = 1 if fn.__name__ == "flash" else 2
        seen["heads"] += [(fn.__name__, local(a).shape[dim]) for a in args]
    return shards(fn, placements, *args)


L.on_local_shards = on_shards
drop = L._drop_padding


def dropped(logits, vocab):
    seen["vocab"].append(local(logits).shape[-1])
    return drop(logits, vocab)


L._drop_padding = dropped
m = fake_mesh((2, 4), ("data", "model"), "cpu")
rec = DR.dryrun_one(name, "small", False, device="cpu", mesh=m, cfg=cfg,
                    shape=ShapeConfig("small", seq, B, kind))
dist.destroy_process_group()
rec["seen"] = seen
print("RECORD " + json.dumps(rec))
"""
# (small-mesh variant, step kind, sequence length): the naive attention
# at S 32, the chunked one at 2,048, and the decode step
PADDED_CASES = {
    "qwen2_train": ("qwen2-0.5b-3h", "train", S),
    "qwen2_train_2k": ("qwen2-0.5b-3h", "train", 2048),
    "qwen2_decode": ("qwen2-0.5b-3h", "decode", S),
    "whisper_train": ("whisper-tiny-3h", "train", S),
    "whisper_prefill": ("whisper-tiny-3h", "prefill", S),
    "whisper_decode": ("whisper-tiny-3h", "decode", S),
}


@pytest.fixture(scope="module")
def padded_records():
    """Each case of PADDED_CASES in a process of its own, side by side."""
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", PADDED, name, kind, str(seq), str(B)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for k, (name, kind, seq) in PADDED_CASES.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
        line = next(l for l in stdout.splitlines()
                    if l.startswith("RECORD "))
        out[k] = json.loads(line[len("RECORD "):])
    return out


@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_heads_hold_their_share_a_rank(padded_records, case):
    """On a 2 x 4 (data, model) mesh, 3 heads (qwen2's smoke config at 3
    heads, one KV head; whisper's at 3 with a 255-token vocab) pad to 4,
    one a rank: q, k and v out of their products, through RoPE and into
    the attention (naive, chunked, decode) hold ceil(3 / 4) = 1 head a
    rank, never the 3 heads gathered; whisper's logits chunk holds 64 of
    the 256 padded vocab columns.  The record is ``ok`` with JAX's
    parameter count for the config: the padding stores nothing."""
    from repro_torch.launch import dryrun as TDR
    name, kind, _ = PADDED_CASES[case]
    rec = padded_records[case]
    assert rec["status"] == "ok"
    arch, over = TDR.SMALL_VARIANTS[name]
    cfg_j = JREG.get_smoke_config(arch).replace(**over)
    assert rec["n_params"] == JRL._param_counts(cfg_j)[0]
    seen = rec["seen"]
    assert seen["heads"] and {h for _, h in seen["heads"]} == {1}, seen
    if kind == "train":
        assert {f for f, _ in seen["heads"]} >= {"_q", "kv_proj"}
    if cfg_j.vocab_size == 255 and kind == "train":
        assert set(seen["vocab"]) == {64}, seen["vocab"]
