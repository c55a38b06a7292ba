"""The port's LM sharding rules (``sharding/rules.py``) against the JAX
package's, tuple for tuple: the sanitized parameter specs of every arch
on the single-pod and the two-pod production mesh, the decode-state
specs, the batch specs and the KV-cache rule over the JAX test's grid;
and ``placements``, which turns a spec into DTensor placements."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as JREG
from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
from repro.launch import specs as JSP
from repro.sharding import rules as JR
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import specs as TSP
from repro_torch.models.model import flatten_params
from repro_torch.sharding import rules as TR

torch.set_num_threads(1)

POD1 = {"data": 16, "model": 16}
POD2 = {"pod": 2, "data": 16, "model": 16}


def jax_specs(tree):
    """A JAX spec tree as {flat key of the port: spec as a tuple}."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    return (JSP.params_shape(JREG.get_config(arch)),
            flatten_params(TSP.params_shape(TREG.get_config(arch))))


@pytest.mark.parametrize("axes", [POD1, POD2], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", TREG.ARCH_IDS)
def test_sanitized_param_specs_match_jax(arch, axes):
    jshape, tflat = _shapes(arch)
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    want = jax_specs(JR.sanitize_specs(JR.param_specs(cfg_j, jshape),
                                       jshape, axes))
    raw = TR.param_specs(cfg_t, tflat)
    assert raw == jax_specs(JR.param_specs(cfg_j, jshape))
    assert TR.sanitize_specs(raw, tflat, axes) == want


@pytest.mark.parametrize("shp", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "whisper-tiny"])
def test_decode_state_specs_match_jax(arch, shp):
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    if shp == "long_500k" and not cfg_t.supports_long_context():
        return
    B = SHAPES_BY_NAME[shp].global_batch
    jshape = JSP.decode_state_shape(cfg_j, J_SHAPES[shp])
    tflat = flatten_params(TSP.decode_state_shape(cfg_t, SHAPES_BY_NAME[shp]))
    for axes in (POD1, POD2):
        want = jax_specs(JR.sanitize_specs(
            JR.decode_state_specs(cfg_j, jshape, B, axes), jshape, axes))
        got = TR.sanitize_specs(TR.decode_state_specs(cfg_t, tflat, B, axes),
                                tflat, axes)
        assert got == want


@pytest.mark.parametrize("arch", TREG.ARCH_IDS)
def test_batch_specs_match_jax(arch):
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    for mp in (False, True):
        want = {k: tuple(v) for k, v in
                JR.train_batch_specs(cfg_j, mp).items()}
        assert TR.train_batch_specs(cfg_t, mp) == want
        assert TR.batch_axis(mp) == JR.batch_axis(mp)
        for b in (1, 16, 31, 32, 128, 256):
            want = {k: tuple(v) for k, v in
                    JR.decode_batch_specs(cfg_j, b, mp).items()}
            assert TR.decode_batch_specs(cfg_t, b, mp) == want
    assert TR.opt_state_specs({"a": ("data",)}) == {"a": ("data",)}


KV = [2, 4, 8, 16, 32, 40]
BATCH = [1, 32, 128, 256]


@pytest.mark.parametrize("path", ["self/0/k", "self/1/v", "self/0/k_scale",
                                  "self/2/conv", "self/0/ssm", "self/1/C",
                                  "self/0/n", "self/0/m"])
def test_cache_leaf_spec_matches_jax(path):
    """The grid of the JAX test's property (kv heads x batch), every cache
    leaf kind at its rank, both meshes."""
    for axes in (POD1, POD2, {"data": 4, "model": 2}):
        for kv in KV:
            for batch in BATCH:
                bs = batch % axes["data"] == 0 and batch >= axes["data"]
                for seq in (32768, 524288, 1500):
                    shape = {"k": (24, batch, seq, kv, 64),
                             "v": (24, batch, seq, kv, 64),
                             "k_scale": (24, batch, seq, kv),
                             "conv": (24, batch, 3, 8192),
                             "ssm": (24, batch, 8192, 16),
                             "C": (24, batch, 4, 512, 512),
                             "n": (24, batch, 4, 512),
                             "m": (24, batch, 4)}[path.split("/")[-1]]
                    want = tuple(JR._cache_leaf_spec(
                        path, shape, batch_sharded=bs, axis_sizes=axes))
                    got = TR._cache_leaf_spec(path, shape, batch_sharded=bs,
                                              axis_sizes=axes)
                    assert got == want, (path, shape, axes)
                    for dim, e in zip(shape, got):
                        assert TR._n_shards(e, axes) == \
                            JR._n_shards(e, axes)


class FakeMesh:
    mesh_dim_names = ("pod", "data", "model")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh()
    assert TR.placements(("model", "data"), m) == (
        Replicate(), Shard(1), Shard(0))
    assert TR.placements((("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert TR.placements((None, None, "model"), m) == (
        Replicate(), Replicate(), Shard(2))
    assert TR.placements((), m) == (Replicate(),) * 3
    assert TR.placements(("data", "pod"), m) == (
        Shard(1), Shard(0), Replicate())


def test_cohort_specs_unchanged():
    assert TR.cohort_param_spec() == TR.REPLICATED
    assert TR.cohort_bucket_specs() == (TR.DATA,) * 4
    assert TR.mesh_axis_sizes(type("M", (), {"shape": {"data": 4,
                                                       "model": 1}})()) \
        == {"data": 4, "model": 1}
