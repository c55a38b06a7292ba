"""The port's shape stand-ins (``launch/specs.py``) and the analytic half
of its roofline (``launch/roofline.py``) against the JAX package's, for
every arch of the registry: the parameter tree's shapes and dtypes key
for key (on the meta device, so nothing is allocated), the decode
states, the step inputs, and the parameter counts, ``model_flops`` and
``analytic_terms`` for every input shape, all exact."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import SHAPES_BY_NAME as J_SHAPES_BY_NAME
from repro.launch import roofline as JRL
from repro.launch import specs as JSP
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import INPUT_SHAPES, SHAPES_BY_NAME
from repro_torch.launch import roofline as TRL
from repro_torch.launch import specs as TSP
from repro_torch.models.model import flatten_params

torch.set_num_threads(1)

ARCHS = TREG.ARCH_IDS
DECODE_ARCHS = ("qwen1.5-32b", "jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny")


def jax_flat(tree):
    """A JAX tree as {flat key of the port: leaf}."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def same_leaves(jflat, tflat):
    assert sorted(jflat) == sorted(tflat)
    for k, j in jflat.items():
        t = tflat[k]
        assert tuple(t.shape) == tuple(j.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), k
        assert t.device.type == "meta", k


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    return JSP.params_shape(JREG.get_config(arch))


@functools.lru_cache(maxsize=None)
def _torch_params_shape(arch):
    return TSP.params_shape(TREG.get_config(arch))


@pytest.fixture
def cached_shapes(monkeypatch):
    """Both roofline modules read params_shape anew per call; serve each
    arch's tree once (the functions are pure)."""
    monkeypatch.setattr(JSP, "params_shape",
                        lambda cfg: _jax_params_shape(cfg.name))
    monkeypatch.setattr(TSP, "params_shape",
                        lambda cfg: _torch_params_shape(cfg.name))


def test_registry_names_match():
    assert list(TREG.ARCH_IDS) == list(JREG.ARCH_IDS)
    for arch in ARCHS:
        assert TREG.get_config(arch).name == arch
    assert [s.name for s in INPUT_SHAPES] == [s.name for s in J_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_matches_jax(arch):
    same_leaves(jax_flat(_jax_params_shape(arch)),
                flatten_params(_torch_params_shape(arch)))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("shp", ["decode_32k", "long_500k"])
def test_decode_state_shape_matches_jax(arch, shp):
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    if shp == "long_500k" and not cfg_t.supports_long_context():
        assert not cfg_j.supports_long_context()
        return
    same_leaves(jax_flat(JSP.decode_state_shape(cfg_j, J_SHAPES_BY_NAME[shp])),
                flatten_params(TSP.decode_state_shape(
                    cfg_t, SHAPES_BY_NAME[shp])))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_inputs_match_jax(arch):
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    for shp in INPUT_SHAPES:
        j = {**JSP.train_input_specs(cfg_j, J_SHAPES_BY_NAME[shp.name]),
             **{f"d_{k}": v for k, v in JSP.decode_input_specs(
                 cfg_j, J_SHAPES_BY_NAME[shp.name]).items()}}
        t = {**TSP.train_input_specs(cfg_t, shp),
             **{f"d_{k}": v for k, v in TSP.decode_input_specs(
                 cfg_t, shp).items()}}
        same_leaves(j, t)


def test_params_shape_allocates_nothing():
    """The largest config's tree lives on the meta device."""
    tree = flatten_params(_torch_params_shape("qwen3-moe-235b-a22b"))
    assert sum(v.numel() for v in tree.values()) > 2e11
    assert {v.device.type for v in tree.values()} == {"meta"}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, cached_shapes):
    assert TRL._param_counts(TREG.get_config(arch)) == \
        JRL._param_counts(JREG.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_analytic_terms_match_jax(arch, cached_shapes):
    cfg_j, cfg_t = JREG.get_config(arch), TREG.get_config(arch)
    for shp in INPUT_SHAPES:
        assert TRL.model_flops(cfg_t, shp) == \
            JRL.model_flops(cfg_j, J_SHAPES_BY_NAME[shp.name])
        for n_dev in (256, 512):
            assert TRL.analytic_terms(cfg_t, shp, n_dev) == \
                JRL.analytic_terms(cfg_j, J_SHAPES_BY_NAME[shp.name], n_dev)


def test_roofline_terms_of_a_record(cached_shapes):
    """roofline_terms of one record: the H100 constants divide the
    analytic terms and the record's collective bytes."""
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    rec = {"status": "ok", "arch": "qwen2-0.5b", "shape": "train_4k",
           "n_devices": 256, "collectives": {"total": 3 * 2**20},
           "memory": {"temp_size_in_bytes": 2**30}, "cost": {"flops": 1.0}}
    t = TRL.roofline_terms(rec)
    ana = TRL.analytic_terms(TREG.get_config("qwen2-0.5b"),
                             SHAPES_BY_NAME["train_4k"], 256)
    assert t["compute_s"] == ana["analytic_flops_dev"] / PEAK_FLOPS_BF16
    assert t["memory_s"] == ana["analytic_hbm_dev"] / HBM_BW
    assert t["collective_s"] == 3 * 2**20 / NVLINK_BW
    assert t["collective_mib"] == 3.0 and t["temp_gib"] == 1.0
    assert t["dominant"] in ("compute", "memory", "collective")
    assert np.isfinite(t["mfu"]) and 0 < t["useful_ratio"] <= 1
    assert TRL.roofline_terms({"status": "skipped", "reason": "x"}) == \
        {"status": "skipped", "reason": "x"}
