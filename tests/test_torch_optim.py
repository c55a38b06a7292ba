"""The port's optimizers against repro.optim: AdamW step for step over
50 steps on a dict of float32 and bf16 leaves, with and without weight
decay (float32 params and both moments within 1e-6 of the leaf's
largest magnitude, bf16 params within one bf16 ulp, ``step`` equal), and
each optimizer of tests/test_substrate.py minimising its quadratic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.optim import adamw as j_adamw
from repro.optim import apply_updates as j_apply
from repro_torch.optim import OptState, adamw, apply_updates, sgd

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

LEAVES = {"w": ((4, 8), "float32"), "b": ((3,), "float32"),
          "e": ((16,), "bfloat16")}
STEPS = 50


def _trees(values):
    jp = {k: jnp.asarray(v, LEAVES[k][1]) for k, v in values.items()}
    tp = {k: torch.tensor(v).to(getattr(torch, LEAVES[k][1]))
          for k, v in values.items()}
    return jp, tp


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    r = np.random.default_rng(7)
    jp, tp = _trees({k: r.normal(size=s).astype(np.float32)
                     for k, (s, _) in LEAVES.items()})
    j_init, j_update = j_adamw(1e-2, weight_decay=weight_decay)
    t_init, t_update = adamw(1e-2, weight_decay=weight_decay)
    js, ts = j_init(jp), t_init(tp)
    for _ in range(STEPS):
        jg, tg = _trees({k: r.normal(size=s).astype(np.float32)
                         for k, (s, _) in LEAVES.items()})
        u, js = j_update(jg, js, jp)
        jp = j_apply(jp, u)
        u, ts = t_update(tg, ts, tp)
        tp = apply_updates(tp, u)
    assert ts.step == int(js.step) == STEPS
    for k, (_, dtype) in LEAVES.items():
        assert tp[k].dtype == getattr(torch, dtype)
        want, got = _f32(jp[k].astype(jnp.float32)), _f32(tp[k])
        if dtype == "bfloat16":
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
            assert np.all(np.abs(got - want) <= ulp), k
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        for moment in ("mu", "nu"):
            want = _f32(getattr(js, moment)[k])
            got = getattr(ts, moment)[k]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_f32(got), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


def test_opt_state_without_second_moment():
    """SGD's state, and a state built as (step, mu), has no ``nu``."""
    assert OptState(3, None).nu is None
    init, update = sgd(0.1, momentum=0.9)
    p = {"w": torch.zeros(2)}
    _, s = update({"w": torch.ones(2)}, init(p), p)
    assert s.step == 1 and s.nu is None and s.mu["w"].dtype == torch.float32


def _quad_loss(p):
    return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()


@pytest.mark.parametrize("maker", [
    lambda: sgd(0.1), lambda: sgd(0.05, momentum=0.9), lambda: adamw(0.1)],
    ids=["sgd", "sgd-momentum", "adamw"])
def test_optimizers_minimize_quadratic(maker):
    init, update = maker()
    p = {"w": torch.zeros(3), "b": torch.zeros(2)}
    s = init(p)
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        g = dict(zip(leaves, torch.autograd.grad(_quad_loss(leaves),
                                                 list(leaves.values()))))
        u, s = update(g, s, p)
        p = apply_updates(p, u)
    assert float(_quad_loss(p)) < 1e-3
