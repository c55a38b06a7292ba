"""The port's LM training step against the JAX package, on the CPU:
``make_token_dataset``, ``chunked_attention``'s hand-written backward,
``chunked_softmax_xent``'s backward, ``loss_fn`` and its grads for the
five dense smoke configs, ``make_train_step``, remat, the flat view of
the parameter tree and the refusal of autograd through the flash
kernel.  Inputs are made from numpy seeds; JAX parameters are carried
across with ``interop`` so each comparison isolates the function under
test.

Tolerances (float32): the attention and xent values and grads within
rtol 1e-4, atol 1e-5 (XLA and torch sum the blocks' products in other
orders); ``loss_fn`` and its grads, and two train steps' params, within
1e-5 relative to each leaf's largest magnitude."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.data.synthetic import make_token_dataset as j_tokens
from repro.kernels import ops as JOPS
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import layers as JL
from repro.models import model as JMD
from repro_torch import interop, rng
from repro_torch.configs import registry as TREG
from repro_torch.data.synthetic import make_token_dataset as t_tokens
from repro_torch.launch.steps import make_train_step as t_make_train_step
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

CPU = torch.device("cpu")
DENSE = ["qwen2-0.5b", "qwen1.5-4b", "qwen1.5-32b", "starcoder2-3b",
         "phi-3-vision-4.2b"]
ATOL, RTOL = 1e-5, 1e-4
REL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JMD.init_params(JREG.get_smoke_config(arch),
                           jax.random.PRNGKey(0))


def _tree(arch):
    return jax.tree.map(np.asarray, _jax_params(arch))


def _lm_batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((b, s), np.float32)}


def _assert_rel(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (and rel where want is all 0)."""
    scale = max(float(np.abs(want).max()), 1.0 if not want.any() else 0.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(num_topics=4, vocab=256,
                                              seq_len=16, n=240, seed=3)])
def test_make_token_dataset_bit_identical(kw):
    jt, jy = j_tokens(**kw)
    tt, ty = t_tokens(**kw)
    assert tt.dtype == jt.dtype == np.int32 and ty.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ty, jy)


# ----------------------------------------------------------------------
# chunked attention: value and (dq, dk, dv) against _flash_mha's VJP
# ----------------------------------------------------------------------

# (causal, window, Sq, Sk, q_offset); blocks q 16, kv 12, so S 40 is
# ragged in both
ATTN_CASES = {
    "causal": (True, 0, 40, 40, 0),
    "window": (True, 7, 40, 40, 0),
    "ragged_sk": (False, 0, 40, 29, 0),
    "causal_ragged_offset": (True, 5, 40, 35, 3),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_value_and_grads_match_jax(case):
    causal, window, sq, sk, q_offset = ATTN_CASES[case]
    B, H, hd, bq, bk = 2, 3, 16, 16, 12
    rs = np.random.default_rng(sorted(ATTN_CASES).index(case))
    q = rs.standard_normal((B, sq, H, hd)).astype(np.float32)
    k = rs.standard_normal((B, sk, H, hd)).astype(np.float32)
    v = rs.standard_normal((B, sk, H, hd)).astype(np.float32)
    dout = rs.standard_normal((B, sq, H, hd)).astype(np.float32)

    @jax.jit
    def jf(q, k, v, dout):
        def f(q, k, v):
            t = lambda a: a.transpose(0, 2, 1, 3)      # noqa: E731
            return t(JL._flash_mha(t(q), t(k), t(v), causal, window, bq,
                                   bk, q_offset))
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(dout)

    j_out, j_grads = jf(q, k, v, dout)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = TL.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 q_block=bq, kv_block=bk, q_offset=q_offset)
    t_grads = torch.autograd.grad(t_out, (tq, tk, tv), torch.tensor(dout))
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_chunked_attention_matches_naive_and_vmaps():
    """Against autograd through the port's naive attention, and under
    torch.func.vmap(torch.func.grad(...)) (the batched runtimes' path)
    against plain autograd, per example."""
    rs = np.random.default_rng(7)
    qkv = [torch.tensor(rs.standard_normal((3, 2, 33, 2, 8)),
                        dtype=torch.float32) for _ in range(3)]

    def loss(fn, q, k, v):
        return fn(q, k, v).square().sum()

    chunked = functools.partial(TL.chunked_attention, causal=True,
                                window=5, q_block=8, kv_block=16)
    naive = functools.partial(TL.naive_attention, causal=True, window=5)
    vm = torch.func.vmap(torch.func.grad(functools.partial(loss, chunked),
                                         argnums=(0, 1, 2)))(*qkv)
    for i in range(3):
        args = [t[i].clone().requires_grad_() for t in qkv]
        want = torch.autograd.grad(loss(naive, *args), args)
        got = torch.autograd.grad(loss(chunked, *args), args)
        for a, b, c in zip(got, want, vm):
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(_np(c[i]), _np(a))


def test_flash_kernel_under_autograd_raises_as_in_jax():
    """Neither package differentiates the flash kernel: jax.grad through
    the Pallas kernel fails, and the port raises NotImplementedError
    from attn_impl='pallas' at S > 1024 rather than using another
    attention."""
    rs = np.random.default_rng(0)
    q = rs.standard_normal((1, 1100, 2, 32)).astype(np.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda a: JOPS.flash_attention(
            a, a, a, causal=True).sum())(jnp.asarray(q))
    tq = torch.tensor(q, requires_grad=True)
    from repro_torch.kernels import ops as TOPS
    with pytest.raises(NotImplementedError, match="no backward"):
        TOPS.flash_attention(tq, tq, tq, causal=True)
    cfg = TREG.get_smoke_config("qwen2-0.5b").replace(attn_impl="pallas")
    params = interop.flat_params_from_numpy(_tree("qwen2-0.5b"), cfg, CPU)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    batch = {k: torch.tensor(v) for k, v in
             _lm_batch(cfg.vocab_size, 1, 1100, 0).items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        TMD.loss_fn(cfg, TMD.nested_params(leaves), batch)
    with torch.no_grad():                    # the forward still serves
        assert torch.isfinite(TMD.loss_fn(cfg, TMD.nested_params(params),
                                          batch))


# ----------------------------------------------------------------------
# chunked softmax xent
# ----------------------------------------------------------------------

# (B, S, D, V, chunk, masked) within tests/test_substrate.py's ranges
# (B 1-3, S 3-40, V 5-50, chunk 2-16, D 8): a ragged last chunk, one
# unmasked chunk-aligned case, a chunk longer than S, and many chunks
XENT_CASES = [(2, 37, 8, 50, 8, True), (1, 32, 8, 23, 16, False),
              (3, 3, 8, 5, 16, True), (2, 33, 8, 11, 2, True)]


@pytest.mark.parametrize("case", XENT_CASES, ids=lambda c: "x".join(
    map(str, c[:5])) + ("m" if c[5] else ""))
def test_chunked_xent_value_and_grads_match_jax(case):
    B, S, D, V, chunk, masked = case
    rs = np.random.default_rng(S * V)
    x = rs.standard_normal((B, S, D)).astype(np.float32)
    w = (rs.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    lab = rs.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rs.random((B, S)) > 0.3) if masked
            else np.ones((B, S), bool)).astype(np.float32)
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda x, w: JL.chunked_softmax_xent(None, x, w, lab, mask,
                                             chunk=chunk),
        argnums=(0, 1)))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    t_val = TL.chunked_softmax_xent(None, tx, tw, torch.tensor(lab),
                                    torch.tensor(mask), chunk=chunk)
    t_grads = torch.autograd.grad(t_val, (tx, tw))
    t_val = float(t_val.detach())
    np.testing.assert_allclose(t_val, float(j_val), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(("dx", "dw"), t_grads, j_grads):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the direct log-softmax, in float64
    logits = x.astype(np.float64) @ w
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    gold = np.take_along_axis(logits, lab[..., None], -1)[..., 0]
    direct = ((lse - gold) * mask).sum() / max(mask.sum(), 1.0)
    np.testing.assert_allclose(t_val, direct, rtol=RTOL)


@pytest.mark.parametrize("arch", TREG.ARCH_IDS)
def test_chunked_xent_dw_matches_jax_on_smoke_configs(arch):
    """The head's gradient, one (D, V) product a chunk with the batch and
    the chunk contracted together (no per-sequence (B, D, V) copies),
    against ``jax.grad`` of the JAX package's loss at each smoke config's
    width (D, V), a ragged last chunk and a mask, with the final hidden
    states and the head weight JAX's (tied archs: the embedding's
    transpose); dx too."""
    cfg = TREG.get_smoke_config(arch)
    p = _tree(arch)
    w = (p["tok_embed"].T if cfg.tie_embeddings else p["lm_head"]
         ).astype(np.float32)
    B, S, chunk = 3, 70, 16
    rs = np.random.default_rng(len(arch))
    x = rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lab = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rs.random((B, S)) > 0.2).astype(np.float32)
    j_grads = jax.jit(jax.grad(
        lambda x, w: JL.chunked_softmax_xent(None, x, w, lab, mask,
                                             chunk=chunk),
        argnums=(0, 1)))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    t_grads = torch.autograd.grad(TL.chunked_softmax_xent(
        None, tx, tw, torch.tensor(lab), torch.tensor(mask), chunk=chunk),
        (tx, tw))
    for name, a, b in zip(("dx", "dw"), t_grads, j_grads):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_chunked_xent_vmaps_over_the_weight():
    rs = np.random.default_rng(1)
    x = torch.tensor(rs.standard_normal((2, 19, 8)), dtype=torch.float32)
    ws = torch.tensor(rs.standard_normal((3, 8, 23)), dtype=torch.float32)
    lab = torch.tensor(rs.integers(0, 23, (2, 19)))
    mask = torch.ones((2, 19))

    def f(w):
        return TL.chunked_softmax_xent(None, x, w, lab, mask, chunk=4)

    vm = torch.func.vmap(torch.func.grad(f))(ws)
    for i in range(3):
        w = ws[i].clone().requires_grad_()
        np.testing.assert_array_equal(
            _np(vm[i]), _np(torch.autograd.grad(f(w), w)[0]))


# ----------------------------------------------------------------------
# loss_fn, the flat view, make_train_step, remat
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_flat_view_runs_in_jax_leaf_order(arch):
    """flatten_tree of the adapter's flat view is concatenate(jax.tree.
    leaves(...)) of the JAX tree, element for element."""
    from repro_torch.core.clustering import flatten_tree
    cfg = TREG.get_smoke_config(arch)
    tree = _tree(arch)
    flat = interop.flat_params_from_numpy(tree, cfg, CPU)
    want = np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(_np(flatten_tree(flat)), want)
    back = interop.flat_params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_flat_view_zero_pads_tuple_indices():
    tree = {"blocks": tuple({"w": torch.full((1,), float(i))}
                            for i in range(12)), "a": torch.zeros(1)}
    flat = TMD.flatten_params(tree)
    assert sorted(flat)[:3] == ["a", "blocks.00.w", "blocks.01.w"]
    assert [float(flat[k]) for k in sorted(flat)][1:] == list(range(12))
    back = TMD.nested_params(flat)
    assert [float(b["w"]) for b in back["blocks"]] == list(range(12))


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, tcfg = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    batch = _lm_batch(tcfg.vocab_size, 3, 20, DENSE.index(arch))
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p: JMD.loss_fn(jcfg, p, batch)))(_jax_params(arch))
    flat = interop.flat_params_from_numpy(_tree(arch), tcfg, CPU)
    names = sorted(flat)
    leaves = [flat[k].requires_grad_() for k in names]
    t_val = TMD.loss_fn(tcfg, TMD.nested_params(dict(zip(names, leaves))),
                        {k: torch.tensor(v) for k, v in batch.items()})
    t_grads = torch.autograd.grad(t_val, leaves)
    _assert_rel(np.float32(float(t_val.detach())), np.float32(j_val), REL,
                "loss")
    for name, a, b in zip(names, t_grads, jax.tree.leaves(j_grads)):
        _assert_rel(_np(a), np.asarray(b), REL, name)


def test_loss_fn_takes_prefix_embeddings():
    """phi-3-vision's image prefix replaces the first P embeddings."""
    arch = "phi-3-vision-4.2b"
    jcfg, tcfg = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    batch = _lm_batch(tcfg.vocab_size, 2, 12, 5)
    pre = np.random.default_rng(9).standard_normal(
        (2, 4, tcfg.d_model)).astype(np.float32)
    want = JMD.loss_fn(jcfg, _jax_params(arch),
                       dict(batch, prefix_embeddings=pre))
    params = interop.model_params_from_numpy(_tree(arch), tcfg, CPU)
    got = TMD.loss_fn(tcfg, params, dict(
        {k: torch.tensor(v) for k, v in batch.items()},
        prefix_embeddings=torch.tensor(pre)))
    _assert_rel(np.float32(float(got)), np.float32(want), REL)


def test_make_train_step_two_steps_match_jax():
    arch = "starcoder2-3b"
    jcfg, tcfg = JREG.get_smoke_config(arch), TREG.get_smoke_config(arch)
    j_step, j_init = j_make_train_step(jcfg, lr=0.05)
    j_step = jax.jit(j_step)
    t_step, t_init = t_make_train_step(tcfg, lr=0.05)
    jp, tp = _jax_params(arch), interop.model_params_from_numpy(
        _tree(arch), tcfg, CPU)
    jo, to = j_init(jp), t_init(tp)
    for s in range(2):
        batch = _lm_batch(tcfg.vocab_size, 2, 24, 100 + s)
        jp, jo, jl = j_step(jp, jo, batch)
        tp, to, tl = t_step(tp, to, {k: torch.tensor(v)
                                     for k, v in batch.items()})
        _assert_rel(np.float32(float(tl)), np.float32(jl), REL, f"loss {s}")
    assert to.step == int(jo.step) == 2
    got = interop.model_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        _assert_rel(a, np.asarray(b), REL)


def test_bf16_train_step_updates_as_apply_updates():
    """bf16 params step as (p.float() + u).to(bf16), loss finite."""
    cfg = TREG.get_smoke_config("qwen2-0.5b").replace(dtype="bfloat16")
    params = TMD.init_params(cfg, rng.PRNGKey(0), CPU)
    step, init = t_make_train_step(cfg, lr=0.5)
    batch = {k: torch.tensor(v) for k, v in
             _lm_batch(cfg.vocab_size, 2, 16, 1).items()}
    flat0 = TMD.flatten_params(params)
    _, grads = TMD.value_and_grad(
        lambda p, b: TMD.loss_fn(cfg, TMD.nested_params(p), b), flat0, batch)
    new, _, loss = step(params, init(params), batch)
    assert torch.isfinite(loss)
    flat1 = TMD.flatten_params(new)
    for k, g in grads.items():
        assert flat1[k].dtype == torch.bfloat16
        want = (flat0[k].float() - 0.5 * g.float()).to(torch.bfloat16)
        assert torch.equal(flat1[k], want), k


@pytest.mark.parametrize("policy", ["nothing", "save_block_out"])
def test_remat_changes_no_number(policy):
    cfg = TREG.get_smoke_config("qwen2-0.5b")
    params = interop.model_params_from_numpy(_tree("qwen2-0.5b"), cfg, CPU)
    batch = {k: torch.tensor(v) for k, v in
             _lm_batch(cfg.vocab_size, 2, 16, 3).items()}
    out = []
    for c in (cfg, cfg.replace(remat=True, remat_policy=policy)):
        step, init = t_make_train_step(c, lr=0.1)
        new, _, loss = step(params, init(params), batch)
        out.append((loss, TMD.flatten_params(new)))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_remat_under_torch_func_raises():
    cfg = TREG.get_smoke_config("qwen2-0.5b").replace(remat=True)
    flat = interop.flat_params_from_numpy(_tree("qwen2-0.5b"), cfg, CPU)
    batch = {k: torch.tensor(v) for k, v in
             _lm_batch(cfg.vocab_size, 1, 8, 0).items()}
    with pytest.raises(NotImplementedError, match="torch.func"):
        torch.func.grad(lambda p: TMD.loss_fn(
            cfg, TMD.nested_params(p), batch))(flat)
