"""The port's transformer serving path against the JAX package: configs,
init, layers, ``logits_fn`` (every attention impl), teacher-forced
decode, the serve loop and the serve CLI, at the smoke configs of
qwen2-0.5b (RMSNorm, SwiGLU, QKV bias, tied embeddings) and
starcoder2-3b (sliding window, GELU, LayerNorm), in float32.  The JAX
parameters are carried across with ``model_params_from_numpy`` so each
comparison isolates the function under test."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models import layers as JL
from repro.models import model as JMD
from repro_torch import interop, rng
from repro_torch.configs import registry as TREG
from repro_torch.kernels import ops as TOPS
from repro_torch.launch import serve as TSERVE
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "starcoder2-3b"]
CPU = torch.device("cpu")


def _cfgs(arch, **kw):
    return (JREG.get_smoke_config(arch).replace(**kw),
            TREG.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JMD.init_params(JREG.get_smoke_config(arch), jax.random.PRNGKey(0))


def _carried(arch, cfg_t):
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    return interop.model_params_from_numpy(tree, cfg_t, CPU)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def test_registry_matches_jax():
    assert TREG.ARCH_IDS == JREG.ARCH_IDS
    for arch in JREG.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            want = dataclasses.asdict(getattr(JREG, get)(arch))
            got = dataclasses.asdict(getattr(TREG, get)(arch))
            assert got == want, (arch, get)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(arch):
    _, cfg_t = _cfgs(arch)
    got = dict(_leaves(interop.model_params_to_numpy(
        TMD.init_params(cfg_t, rng.PRNGKey(0), CPU))))
    want = dict(_leaves(jax.tree.map(np.asarray, _jax_params(arch))))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_norm_mlp_match_jax(arch):
    cfg_j, cfg_t = _cfgs(arch)
    bp = _carried(arch, cfg_t)["blocks"][0]
    jbp = _jax_params(arch)["blocks"][0]
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 24, cfg_j.d_model)).astype(np.float32)
    qk = g.standard_normal((2, 24, 3, cfg_j.resolved_head_dim)).astype(
        np.float32)
    pos = np.arange(100, 124)[None]
    np.testing.assert_allclose(
        TL.apply_rope(torch.tensor(qk), torch.tensor(pos),
                      cfg_t.rope_theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(qk), jnp.asarray(pos),
                                 cfg_j.rope_theta)), rtol=1e-5, atol=1e-5)
    norm_j = jax.tree.map(lambda a: a[0], jbp["ln1"])
    norm_t = {k: v[0] for k, v in bp["ln1"].items()}
    assert ("bias" in norm_t) == (cfg_t.norm_kind == "layernorm")
    np.testing.assert_allclose(
        TL.apply_norm(norm_t, torch.tensor(x), cfg_t.norm_eps).numpy(),
        np.asarray(JL.apply_norm(norm_j, jnp.asarray(x), cfg_j.norm_eps)),
        rtol=1e-5, atol=1e-5)
    mlp_j = jax.tree.map(lambda a: a[0], jbp["ffn"])
    mlp_t = {k: v[0] for k, v in bp["ffn"].items()}
    np.testing.assert_allclose(
        TL.apply_mlp(mlp_t, torch.tensor(x)).numpy(),
        np.asarray(JL.apply_mlp(mlp_j, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_expand_kv_repeats_each_head_in_a_row():
    k = np.random.default_rng(2).standard_normal((1, 5, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TL._expand_kv(torch.tensor(k), 6).numpy(),
        np.asarray(JL._expand_kv(jnp.asarray(k), 6)))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_short(arch):
    cfg_j, cfg_t = _cfgs(arch)
    toks = _tokens(cfg_j, 2, 32, 3)
    want = np.asarray(JMD.logits_fn(cfg_j, _jax_params(arch),
                                    jnp.asarray(toks)))
    got = TMD.logits_fn(cfg_t, _carried(arch, cfg_t), torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_long_logits(arch, s):
    cfg_j = JREG.get_smoke_config(arch).replace(attn_impl="naive")
    toks = _tokens(cfg_j, 1, s, 4)
    return toks, np.asarray(JMD.logits_fn(cfg_j, _jax_params(arch),
                                          jnp.asarray(toks)))


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_past_the_naive_cutoff(arch, impl):
    """S = 1040 > 1024: ``pallas`` runs ops.flash_attention (its plain
    version on the CPU, no launch) and ``chunked`` the blockwise torch
    attention; both against the JAX naive path at the same S."""
    _, cfg_t = _cfgs(arch, attn_impl=impl)
    toks, want = _jax_long_logits(arch, 1040)
    before = TOPS.flash_attention.launches
    got = TMD.logits_fn(cfg_t, _carried(arch, cfg_t), torch.tensor(toks))
    assert TOPS.flash_attention.launches == before == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_decode_step(cfg):
    return jax.jit(functools.partial(JMD.decode_step, cfg))


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch, kv):
    """S = 20 passes starcoder2's smoke window of 16, so its ring buffer
    wraps."""
    cfg_j, cfg_t = _cfgs(arch, kv_cache_dtype=kv)
    b, s = 2, 20
    toks = _tokens(cfg_j, b, s, 5)
    params_t = _carried(arch, cfg_t)
    step_j = _jax_decode_step(cfg_j)
    state_j = JMD.init_decode_state(cfg_j, b, s)
    state_t = TMD.init_decode_state(cfg_t, b, s, CPU)
    for t in range(s):
        lg_j, state_j = step_j(_jax_params(arch), state_j,
                               jnp.asarray(toks[:, t]), jnp.int32(t))
        lg_t, state_t = TMD.decode_step(cfg_t, params_t, state_t,
                                        torch.tensor(toks[:, t]), t)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   rtol=1e-4, atol=1e-4, err_msg=f"t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_ids_match_jax(arch):
    cfg_j, cfg_t = _cfgs(arch)
    b, prompt_len, gen = 2, 8, 12
    out = TSERVE.serve(cfg_t, _carried(arch, cfg_t), b, prompt_len, gen, CPU)
    prompts = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    2),
                                 (b, prompt_len), 0, cfg_j.vocab_size)
    np.testing.assert_array_equal(out["prompts"].numpy(),
                                  np.asarray(prompts))
    step = jax.jit(j_make_serve_step(cfg_j))
    state = JMD.init_decode_state(cfg_j, b, prompt_len + gen)
    for t in range(prompt_len - 1):
        _, state = step(_jax_params(arch), state, prompts[:, t],
                        jnp.int32(t))
    tok, ids = prompts[:, -1], []
    for t in range(gen):
        tok, state = step(_jax_params(arch), state, tok,
                          jnp.int32(prompt_len - 1 + t))
        ids.append(np.asarray(tok))
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(ids, 1))


def _sample_ids(module, extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    r = subprocess.run([sys.executable, "-m", module, *extra],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [l for l in r.stdout.splitlines()
             if l.startswith("sample token ids:")]
    assert len(lines) == 1, r.stdout
    return lines[0]


def test_serve_cli_prints_the_jax_cli_ids():
    """Both CLIs at their defaults (qwen2-0.5b smoke, batch 4, prompt 16,
    32 generated).  ``--quiet`` is left out: the JAX CLI prints its ids
    through a progress log that --quiet silences."""
    want = _sample_ids("repro.launch.serve", [])
    got = _sample_ids("repro_torch.launch.serve", ["--device", "cpu"])
    assert got == want


def test_prefix_embeddings_match_jax():
    """The multimodal prefix takes the first P token slots (phi-3-vision's
    smoke config, 8 prefix tokens)."""
    cfg_j, cfg_t = _cfgs("phi-3-vision-4.2b")
    params_j = JMD.init_params(cfg_j, jax.random.PRNGKey(1))
    params_t = interop.model_params_from_numpy(
        jax.tree.map(np.asarray, params_j), cfg_t, CPU)
    g = np.random.default_rng(6)
    toks = _tokens(cfg_j, 2, 24, 6)
    prefix = g.standard_normal((2, 8, cfg_j.d_model)).astype(np.float32)
    want = np.asarray(JMD.logits_fn(cfg_j, params_j, jnp.asarray(toks),
                                    prefix_embeddings=jnp.asarray(prefix)))
    got = TMD.logits_fn(cfg_t, params_t, torch.tensor(toks),
                        prefix_embeddings=torch.tensor(prefix))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="prefix"):
        TMD.init_decode_state(cfg_t, 2, 24, CPU)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "whisper-tiny"])
def test_unported_blocks_raise(arch):
    cfg = TREG.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="the rest of the model zoo"):
        TMD.init_params(cfg, rng.PRNGKey(0), CPU)
    with pytest.raises(NotImplementedError, match="the rest of the model zoo"):
        TMD.init_decode_state(cfg, 1, 4, CPU)
