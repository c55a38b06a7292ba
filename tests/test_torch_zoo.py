"""The MoE, Mamba and xLSTM archs in the port against the JAX package on
the CPU, at the smoke configs of granite-moe-3b-a800m, qwen3-moe-235b-
a22b, jamba-v0.1-52b and xlstm-1.3b (float32): init, the flat view,
``logits_fn``, ``loss_fn`` with the MoE auxiliary loss and its grads,
teacher-forced decode, decode against the forward pass, and the serve
CLI's ids.

Tolerances: logits within 1e-5 of the largest logit; loss within 1e-5
relative and each grad within 1e-5 of its largest element (of the
whole gradient's largest, for a leaf of rounding noise under a
thousandth of it); decode logits within 1e-4 of JAX's decode.  Decode against the forward pass
follows tests/test_models.py: ``attn_impl="naive"``, capacity factor
8.0 (no token dropped at either shape), the largest relative gap under
2e-2, and for the MoE archs, where a router on a top-k tie may flip an
expert, at least 70 % of positions under 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro_torch import interop, rng
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import BlockSpec
from repro_torch.core.clustering import flatten_tree
from repro_torch.launch import serve as TSERVE
from repro_torch.models import model as TMD

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
         "xlstm-1.3b"]
MOE_ARCHS = ARCHS[:2]
REL = 1e-5
# `python -m repro.launch.serve --arch A`'s `sample token ids` line
JAX_CLI_IDS = {
    "granite-moe-3b-a800m": [242] * 15 + [217],
    "qwen3-moe-235b-a22b": [218, 99, 99, 99, 99, 99, 188, 143, 199, 143, 6,
                            99, 188, 99, 188, 143],
    "jamba-v0.1-52b": [87, 243, 217, 131, 66, 69, 136, 25, 108, 230, 22, 217,
                       127, 127, 20, 111],
    "xlstm-1.3b": [144] * 16,
}

_JAX_PARAMS = {}


def _jax_params(arch, seed=0):
    if (arch, seed) not in _JAX_PARAMS:
        _JAX_PARAMS[arch, seed] = JMD.init_params(
            JREG.get_smoke_config(arch), jax.random.PRNGKey(seed))
    return _JAX_PARAMS[arch, seed]


def _carried(arch, cfg_t, seed=0):
    return interop.model_params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(arch, seed)), cfg_t, CPU)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _assert_rel(got, want, rel, msg=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * max(scale, 1e-30), (msg, err, scale)


def test_check_supported_accepts_the_block_zoo():
    """Nothing is refused any more: every mixer with every FFN, and every
    registry arch at its smoke config (whisper's encoder-decoder, the
    prefix config, learned positions), inits and takes a decode step
    with finite float32 logits."""
    base = TREG.get_smoke_config("granite-moe-3b-a800m")
    cfgs = [base.replace(cycle=(BlockSpec(mixer, ffn),))
            for mixer in ("attn", "mamba", "mlstm", "slstm")
            for ffn in ("mlp", "moe", "none")]
    cfgs += [TREG.get_smoke_config(a) for a in TREG.ARCH_IDS]
    cfgs.append(base.replace(learned_pos=True))
    for cfg in cfgs:
        params = TMD.init_params(cfg, rng.PRNGKey(0), CPU)
        state = TMD.init_decode_state(cfg, 2, 4, CPU)
        logits, _ = TMD.decode_step(cfg, params, state,
                                    torch.tensor([1, 2]), 0)
        assert logits.shape == (2, cfg.vocab_size), cfg.name
        assert logits.dtype == torch.float32, cfg.name
        assert bool(torch.isfinite(logits).all()), cfg.name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax_leaf_for_leaf(arch):
    """The flat view's sorted keys run in jax.tree.leaves order, leaf for
    leaf of the same shape and type, each JAX's bit for bit, constant
    and drawn leaves alike."""
    cfg_t = TREG.get_smoke_config(arch)
    flat = TMD.flatten_params(TMD.init_params(cfg_t, rng.PRNGKey(0), CPU))
    paths = jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0]
    assert len(paths) == len(flat)
    for key, (path, leaf) in zip(sorted(flat), paths):
        want = np.asarray(leaf)
        names = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        assert key.split(".")[-1] == names[-1], (key, names)
        got = flat[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_view_runs_in_jax_leaf_order(arch):
    cfg_t = TREG.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    flat = interop.flat_params_from_numpy(tree, cfg_t, CPU)
    want = np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(flatten_tree(flat).numpy(), want)
    back = interop.flat_params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_bf16_tree_keeps_each_leaf_type():
    """A bf16 granite-moe smoke tree crosses over with its float32 router
    float32 and its bf16 weights bf16, values unchanged."""
    cfg_j = JREG.get_smoke_config("granite-moe-3b-a800m").replace(
        dtype="bfloat16")
    cfg_t = TREG.get_smoke_config("granite-moe-3b-a800m").replace(
        dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JMD.init_params(cfg_j,
                                                    jax.random.PRNGKey(0)))
    flat = interop.flat_params_from_numpy(tree, cfg_t, CPU)
    init = TMD.flatten_params(TMD.init_params(cfg_t, rng.PRNGKey(0), CPU))
    leaves = jax.tree.leaves(tree)
    for key, want in zip(sorted(flat), leaves):
        dt = torch.float32 if want.dtype == np.float32 else torch.bfloat16
        assert flat[key].dtype == init[key].dtype == dt, key
        np.testing.assert_array_equal(flat[key].float().numpy(),
                                      want.astype(np.float32), err_msg=key)
    assert {str(a.dtype) for a in leaves} == {"float32", "bfloat16"}
    assert flat["blocks.0.ffn.router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch):
    cfg_j, cfg_t = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    toks = _tokens(cfg_j.vocab_size, 2, 40, ARCHS.index(arch))
    want = np.asarray(JMD.logits_fn(cfg_j, _jax_params(arch),
                                    jnp.asarray(toks)))
    got = TMD.logits_fn(cfg_t, _carried(arch, cfg_t), torch.tensor(toks))
    _assert_rel(got.numpy(), want, REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn with the MoE auxiliary loss (0.01 x the summed per-block
    Switch losses) and its gradient, leaf for leaf."""
    cfg_j, cfg_t = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    toks = _tokens(cfg_j.vocab_size, 2, 21, 10 + ARCHS.index(arch))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": np.ones((2, 20), np.float32)}
    j_val, j_grads = jax.value_and_grad(
        lambda p: JMD.loss_fn(cfg_j, p, batch))(_jax_params(arch))
    flat = TMD.flatten_params(_carried(arch, cfg_t))
    names = sorted(flat)
    leaves = [flat[k].requires_grad_() for k in names]
    t_val = TMD.loss_fn(cfg_t, TMD.nested_params(dict(zip(names, leaves))),
                        {k: torch.tensor(v) for k, v in batch.items()})
    t_grads = torch.autograd.grad(t_val, leaves)
    _assert_rel(np.float32(float(t_val)), np.float32(j_val), REL, "loss")
    want = [np.asarray(b) for b in jax.tree.leaves(j_grads)]
    top = max(float(np.abs(b).max()) for b in want)
    for name, a, b in zip(names, t_grads, want):
        # a leaf's own largest element sets its bound; a leaf under a
        # thousandth of the tree's largest is held to the tree's: the
        # sLSTM's i-gate bias has a gradient of rounding noise (2e-8;
        # the stabiliser cancels in c / n), which no order of sums
        # reproduces
        own = float(np.abs(b).max())
        err = float(np.abs(a.numpy() - b).max())
        assert err <= REL * (own if own >= 1e-3 * top else top), (
            name, err, own)
    if arch in MOE_ARCHS:        # the auxiliary loss is in the value
        x, aux = TMD.forward(cfg_t, _carried(arch, cfg_t),
                             torch.tensor(batch["tokens"]))
        _, j_aux = JMD.forward(cfg_j, _jax_params(arch),
                               jnp.asarray(batch["tokens"]))
        assert float(aux) > 0
        _assert_rel(np.float32(float(aux)), np.float32(j_aux), REL, "aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    cfg_j, cfg_t = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    b, s = 2, 12
    toks = _tokens(cfg_j.vocab_size, b, s, 20 + ARCHS.index(arch))
    params_t = _carried(arch, cfg_t)
    step_j = jax.jit(lambda p, st, tk, pos: JMD.decode_step(cfg_j, p, st,
                                                            tk, pos))
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
def test_decode_matches_forward(arch):
    """tests/test_models.py's rules, on the port alone."""
    cfg = TREG.get_smoke_config(arch).replace(attn_impl="naive",
                                              moe_capacity_factor=8.0)
    params = TMD.init_params(cfg, rng.PRNGKey(5), CPU)
    B, S = 2, 20
    toks = rng.randint(rng.PRNGKey(6), (B, S), 0, cfg.vocab_size, CPU)
    full = TMD.logits_fn(cfg, params, toks)
    state = TMD.init_decode_state(cfg, B, S, CPU)
    outs = []
    for t in range(S):
        lg, state = TMD.decode_step(cfg, params, state, toks[:, t], t)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    scale = float(full.abs().max())
    per_pos = ((dec - full).abs().amax(dim=(0, 2)) / scale).numpy()
    if arch in MOE_ARCHS:
        assert (per_pos < 2e-2).mean() >= 0.7, per_pos
    else:
        assert per_pos.max() < 2e-2, per_pos


def test_bf16_jamba_decode_tracks_the_forward():
    """jamba's smoke config in bfloat16: the Mamba conv sums its taps in
    float32 and rounds once on both paths (as XLA computes the
    reference's fused chain), so decode keeps every position within 2e-2
    of the forward pass; rounding at every tap drifted, and the MoE
    routers turned the drift into expert flips."""
    cfg = TREG.get_smoke_config("jamba-v0.1-52b").replace(
        attn_impl="naive", moe_capacity_factor=8.0, dtype="bfloat16")
    params = TMD.init_params(cfg, rng.PRNGKey(5), CPU)
    toks = rng.randint(rng.PRNGKey(6), (1, 48), 0, cfg.vocab_size, CPU)
    full = TMD.logits_fn(cfg, params, toks)[0].float()
    state = TMD.init_decode_state(cfg, 1, 48, CPU)
    gap = []
    for t in range(48):
        lg, state = TMD.decode_step(cfg, params, state, toks[:, t], t)
        gap.append(float((lg[0] - full[t]).abs().max()))
    assert max(gap) / float(full.abs().max()) < 2e-2, gap


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_prints_the_jax_cli_ids(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch A`` at its
    defaults (smoke config, batch 4, prompt 16, 32 generated)."""
    out = TSERVE.main(["--device", "cpu", "--arch", arch])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("sample token ids:")]
    assert lines == [f"sample token ids: {JAX_CLI_IDS[arch]}"]
    assert out["tokens"][0, :16].tolist() == JAX_CLI_IDS[arch]


@pytest.mark.parametrize("policy", ["nothing", "save_block_out"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "xlstm-1.3b"])
def test_remat_changes_no_number(arch, policy):
    """Remat over MoE blocks (the summed auxiliary loss rides through
    torch.utils.checkpoint) and over FFN-less blocks."""
    cfg = TREG.get_smoke_config(arch)
    params = TMD.init_params(cfg, rng.PRNGKey(0), CPU)
    toks = _tokens(cfg.vocab_size, 2, 17, 30)
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:]),
             "mask": torch.ones(2, 16)}
    out = []
    for c in (cfg, cfg.replace(remat=True, remat_policy=policy)):
        out.append(TMD.value_and_grad(
            lambda p, b: TMD.loss_fn(c, TMD.nested_params(p), b),
            TMD.flatten_params(params), batch))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
