"""whisper-tiny's encoder-decoder and phi-3-vision's decode in the port
against the JAX package on the CPU, at the smoke configs (float32): init
and the flat view, ``encode``, ``logits_fn`` and ``loss_fn`` with its
grads over encoder frames, ``build_cross_cache``, teacher-forced decode,
decode against the forward pass, the serve CLI's ids; the types of a
bf16 config over float32 frames; the encoder over more than 1,024 frames
under ``attn_impl="pallas"`` against the JAX package's Pallas kernel
(interpreted).

Tolerances follow tests/test_torch_zoo.py: values within 1e-5 of the
largest (a grad leaf: of its own largest, or of the tree's for a leaf
under a thousandth of it), decode logits within 1e-4 of JAX's decode,
and decode against the forward pass under tests/test_models.py's rule
(the largest relative gap under 2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro_torch import interop, rng
from repro_torch.configs import registry as TREG
from repro_torch.core.clustering import flatten_tree
from repro_torch.kernels import ops as TOPS
from repro_torch.launch import serve as TSERVE
from repro_torch.models import model as TMD

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "whisper-tiny"
REL = 1e-5
# `python -m repro.launch.serve --arch A`'s `sample token ids` line
JAX_CLI_IDS = {
    "whisper-tiny": [214, 151, 214, 205, 155, 205, 32, 204, 32, 32, 204,
                     32, 32, 155, 32, 32],
    "phi-3-vision-4.2b": [52, 108, 145, 204, 187, 187, 187, 187, 187, 187,
                          122, 67, 52, 187, 59, 57],
}

_JAX_PARAMS = {}


def _cfgs(arch=ARCH, **kw):
    return (JREG.get_smoke_config(arch).replace(**kw),
            TREG.get_smoke_config(arch).replace(**kw))


def _jax_params(arch=ARCH):
    if arch not in _JAX_PARAMS:
        cfg = JREG.get_smoke_config(arch)
        _JAX_PARAMS[arch] = jax.jit(lambda k: JMD.init_params(cfg, k))(
            jax.random.PRNGKey(0))
    return _JAX_PARAMS[arch]


def _carried(cfg_t, arch=ARCH):
    return interop.model_params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(arch)), cfg_t, CPU)


def _frames(cfg, b, seed):
    g = np.random.default_rng(seed)
    return g.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _assert_rel(got, want, rel=REL, msg=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * max(scale, 1e-30), (msg, err, scale)


def test_init_matches_jax_bit_for_bit():
    """The tree, the draws and the flat view: every leaf of the JAX tree,
    in jax.tree.leaves order, bit for bit.  The encoder's blocks carry
    the (unused) cross-attention too, as the JAX package builds them."""
    _, cfg_t = _cfgs()
    params = TMD.init_params(cfg_t, rng.PRNGKey(0), CPU)
    assert sorted(params["enc"]["blocks"][0]) == sorted(
        _jax_params()["enc"]["blocks"][0])
    assert "cross" in params["enc"]["blocks"][0]
    flat = TMD.flatten_params(params)
    paths = jax.tree_util.tree_flatten_with_path(_jax_params())[0]
    assert len(paths) == len(flat)
    for key, (path, leaf) in zip(sorted(flat), paths):
        names = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        assert key.split(".") == [n for n in names], (key, names)
        want = np.asarray(leaf)
        got = flat[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_jax_tree_round_trips_through_the_flat_view():
    _, cfg_t = _cfgs()
    tree = jax.tree.map(np.asarray, _jax_params())
    flat = interop.flat_params_from_numpy(tree, cfg_t, CPU)
    want = np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(flatten_tree(flat).numpy(), want)
    back = interop.flat_params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_encode_and_cross_cache_match_jax():
    cfg_j, cfg_t = _cfgs()
    frames = _frames(cfg_j, 2, 1)
    enc_j = JMD.encode(cfg_j, _jax_params(), jnp.asarray(frames))
    params_t = _carried(cfg_t)
    enc_t = TMD.encode(cfg_t, params_t, torch.tensor(frames))
    _assert_rel(enc_t.numpy(), np.asarray(enc_j), REL, "encode")
    cross_j = JMD.build_cross_cache(cfg_j, _jax_params(), enc_j)
    cross_t = TMD.build_cross_cache(cfg_t, params_t, enc_t)
    for k in ("k", "v"):
        assert tuple(cross_t[k].shape) == cross_j[k].shape
        _assert_rel(cross_t[k].numpy(), np.asarray(cross_j[k]), REL, k)


def test_logits_match_jax():
    cfg_j, cfg_t = _cfgs()
    frames = _frames(cfg_j, 2, 2)
    toks = _tokens(cfg_j, 2, 20, 2)
    want = np.asarray(JMD.logits_fn(cfg_j, _jax_params(), jnp.asarray(toks),
                                    encoder_frames=jnp.asarray(frames)))
    got = TMD.logits_fn(cfg_t, _carried(cfg_t), torch.tensor(toks),
                        encoder_frames=torch.tensor(frames))
    _assert_rel(got.numpy(), want, REL)


def test_loss_and_grads_match_jax():
    """loss_fn over encoder frames and its gradient, leaf for leaf: the
    decoder's cross-attention carries the gradient into the encoder."""
    cfg_j, cfg_t = _cfgs()
    toks = _tokens(cfg_j, 2, 17, 3)
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": np.ones((2, 16), np.float32),
             "encoder_frames": _frames(cfg_j, 2, 3)}
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p: JMD.loss_fn(cfg_j, p, batch)))(_jax_params())
    flat = TMD.flatten_params(_carried(cfg_t))
    names = sorted(flat)
    leaves = [flat[k].requires_grad_() for k in names]
    t_val = TMD.loss_fn(cfg_t, TMD.nested_params(dict(zip(names, leaves))),
                        {k: torch.tensor(v) for k, v in batch.items()})
    # the encoder's cross sublayers are never used: no gradient reaches
    # them (JAX returns zeros there)
    t_grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(t_val, leaves, allow_unused=True))]
    _assert_rel(np.float32(t_val.item()), np.float32(j_val), REL, "loss")
    want = [np.asarray(b) for b in jax.tree.leaves(j_grads)]
    top = max(float(np.abs(b).max()) for b in want)
    for name, a, b in zip(names, t_grads, want):
        own = float(np.abs(b).max())
        err = float(np.abs(a.numpy() - b).max())
        assert err <= REL * (own if own >= 1e-3 * top else top), (
            name, err, own)
    assert not np.abs(np.asarray(
        j_grads["enc"]["blocks"][0]["cross"]["wq"])).any()


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_teacher_forced_decode_matches_jax(arch):
    """Learned positions and the cross-attention over the cross cache
    (whisper); phi-3-vision's prefix config decodes its tokens, which
    never read a prefix, in either package."""
    cfg_j, cfg_t = _cfgs(arch)
    b, s = 2, 12
    toks = _tokens(cfg_j, b, s, 4)
    params_t = _carried(cfg_t, arch)
    state_j = JMD.init_decode_state(cfg_j, b, s)
    state_t = TMD.init_decode_state(cfg_t, b, s, CPU)
    if cfg_j.is_encdec:
        frames = _frames(cfg_j, b, 4)
        state_j["cross"] = JMD.build_cross_cache(
            cfg_j, _jax_params(arch),
            JMD.encode(cfg_j, _jax_params(arch), jnp.asarray(frames)))
        state_t["cross"] = TMD.build_cross_cache(
            cfg_t, params_t, TMD.encode(cfg_t, params_t,
                                        torch.tensor(frames)))
    step_j = jax.jit(lambda p, st, tk, pos: JMD.decode_step(cfg_j, p, st,
                                                            tk, pos))
    for t in range(s):
        lg_j, state_j = step_j(_jax_params(arch), state_j,
                               jnp.asarray(toks[:, t]), jnp.int32(t))
        lg_t, state_t = TMD.decode_step(cfg_t, params_t, state_t,
                                        torch.tensor(toks[:, t]), t)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   rtol=1e-4, atol=1e-4, err_msg=f"t={t}")


def test_decode_matches_forward():
    """tests/test_models.py's rule on the port alone: decode over the
    cross cache against logits_fn over the same frames."""
    cfg = TREG.get_smoke_config(ARCH).replace(attn_impl="naive")
    params = TMD.init_params(cfg, rng.PRNGKey(5), CPU)
    B, S = 2, 20
    toks = rng.randint(rng.PRNGKey(6), (B, S), 0, cfg.vocab_size, CPU)
    frames = rng.normal(rng.PRNGKey(7), (B, cfg.encoder_seq, cfg.d_model),
                        CPU)
    full = TMD.logits_fn(cfg, params, toks, encoder_frames=frames)
    state = TMD.init_decode_state(cfg, B, S, CPU)
    state["cross"] = TMD.build_cross_cache(cfg, params,
                                           TMD.encode(cfg, params, frames))
    dec = torch.stack([TMD.decode_step(cfg, params, state, toks[:, t], t)[0]
                       for t in range(S)], dim=1)
    scale = float(full.abs().max())
    per_pos = ((dec - full).abs().amax(dim=(0, 2)) / scale).numpy()
    assert per_pos.max() < 2e-2, per_pos


@pytest.mark.parametrize("arch", sorted(JAX_CLI_IDS))
def test_serve_cli_prints_the_jax_cli_ids(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch A`` at its
    defaults (smoke config, batch 4, prompt 16, 32 generated); whisper
    encodes the JAX CLI's frames first."""
    out = TSERVE.main(["--device", "cpu", "--arch", arch])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("sample token ids:")]
    assert lines == [f"sample token ids: {JAX_CLI_IDS[arch]}"]
    assert out["tokens"][0, :16].tolist() == JAX_CLI_IDS[arch]


def test_bf16_config_over_float32_frames_takes_jax_types():
    """As the serve CLI runs a bf16 whisper: float32 frames promote the
    whole encoder to float32, so the encoder output and the cross K/V are
    float32, logits_fn is bf16 and a decode step's logits float32."""
    cfg_j, cfg_t = _cfgs(dtype="bfloat16")
    frames = _frames(cfg_j, 1, 8)
    toks = _tokens(cfg_j, 1, 6, 8)
    params_j = JMD.init_params(cfg_j, jax.random.PRNGKey(0))
    enc_j = jax.eval_shape(lambda p, f: JMD.encode(cfg_j, p, f), params_j,
                           frames)
    cross_j = jax.eval_shape(lambda p, e: JMD.build_cross_cache(cfg_j, p, e),
                             params_j, enc_j)
    logits_j = jax.eval_shape(lambda p, t, f: JMD.logits_fn(
        cfg_j, p, t, encoder_frames=f), params_j, toks, frames)

    def step(p, t, f):
        st = JMD.init_decode_state(cfg_j, 1, 6)
        st["cross"] = JMD.build_cross_cache(cfg_j, p,
                                            JMD.encode(cfg_j, p, f))
        return JMD.decode_step(cfg_j, p, st, t[:, 0], jnp.int32(0))[0]

    dec_j = jax.eval_shape(step, params_j, toks, frames)
    params = TMD.init_params(cfg_t, rng.PRNGKey(0), CPU)
    enc = TMD.encode(cfg_t, params, torch.tensor(frames))
    cross = TMD.build_cross_cache(cfg_t, params, enc)
    logits = TMD.logits_fn(cfg_t, params, torch.tensor(toks),
                           encoder_frames=torch.tensor(frames))
    state = TMD.init_decode_state(cfg_t, 1, 6, CPU)
    state["cross"] = cross
    dec = TMD.decode_step(cfg_t, params, state, torch.tensor(toks[:, 0]),
                          0)[0]
    got = [str(t.dtype).replace("torch.", "")
           for t in (enc, cross["k"], cross["v"], logits, dec)]
    want = [str(t.dtype) for t in (enc_j, cross_j["k"], cross_j["v"],
                                   logits_j, dec_j)]
    assert got == want == ["float32", "float32", "float32", "bfloat16",
                           "float32"]
    assert bool(torch.isfinite(dec).all())


def test_encoder_over_1024_frames_under_pallas():
    """One encoder layer over 1,100 frames (B 1, H 2, hd 64): past 1,024
    positions ``attn_impl="pallas"`` takes the kernel, non-causal with a
    ragged last block; JAX runs its Pallas kernel interpreted, the port
    the kernel's plain version (on the CPU)."""
    kw = dict(encoder_layers=1, encoder_seq=1100, num_heads=2,
              num_kv_heads=2, attn_impl="pallas")
    cfg_j, cfg_t = _cfgs(**kw)
    params_j = JMD.init_params(cfg_j, jax.random.PRNGKey(2))
    params_t = interop.model_params_from_numpy(
        jax.tree.map(np.asarray, params_j), cfg_t, CPU)
    frames = _frames(cfg_j, 1, 9)
    want = np.asarray(JMD.encode(cfg_j, params_j, jnp.asarray(frames)))
    got = TMD.encode(cfg_t, params_t, torch.tensor(frames))
    _assert_rel(got.numpy(), want, REL)
    assert TOPS.flash_attention.launches == 0     # the CPU never launches
