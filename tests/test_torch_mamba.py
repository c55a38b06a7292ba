"""The port's Mamba mixer (``repro_torch.models.mamba``) against the JAX
package's ``repro.models.mamba`` on the CPU, at jamba's smoke width
(d_model 128, d_inner 256, d_state 16, d_conv 4, dt_rank 8) in float32.

Weights are JAX's, carried through numpy.  The chunked scan is held
within 1e-5 of the largest output (the associative scan pairs the
products as XLA's does, but XLA may fuse a multiply-add that torch
rounds twice); sequence lengths off the chunk size exercise the
padding.  The decode recurrence is held to JAX's step for step, and to
the port's own full-sequence form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import mamba as JM
from repro_torch import rng, xla_math as XM
from repro_torch.configs import registry as TREG
from repro_torch.models import mamba as TM

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
CPU = torch.device("cpu")
REL = 1e-5


def _cfgs():
    return JREG.get_smoke_config(ARCH), TREG.get_smoke_config(ARCH)


def _weights(seed=0):
    cfg_j, _ = _cfgs()
    p = JM.init_mamba(jax.random.PRNGKey(seed), cfg_j)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 128)).astype(np.float32)


def _assert_rel(got, want, rel=REL, msg=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (msg, err, scale)


def test_init_matches_jax():
    """Each leaf's shape and type as JAX's, and every leaf bit for bit:
    the constants (``a_log`` in XLA's log, ``b_dt``, ``d_skip``,
    ``conv_b``) and the drawn weights (XLA's erfinv, ``xla_math``)."""
    cfg_j, cfg_t = _cfgs()
    pj = JM.init_mamba(jax.random.PRNGKey(3), cfg_j)
    pt = TM.init_mamba(rng.PRNGKey(3), cfg_t, device=CPU)
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        a = np.asarray(v)
        assert tuple(pt[k].shape) == a.shape and str(pt[k].dtype).endswith(
            str(a.dtype)), k
        np.testing.assert_array_equal(pt[k].numpy(), a, err_msg=k)


def test_xla_log_matches_jnp_log_on_the_init_range():
    ks = np.arange(1, 257, dtype=np.float32)
    np.testing.assert_array_equal(XM.log(torch.tensor(ks)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(ks))))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 257])
def test_associative_scan_matches_lax_and_a_loop(n):
    g = np.random.default_rng(n)
    a = g.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = g.standard_normal((2, n, 3, 4)).astype(np.float32)
    _, want = jax.lax.associative_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    _, got = TM.associative_scan(torch.tensor(a), torch.tensor(b))
    _assert_rel(got.numpy(), np.asarray(want), 1e-6)
    h, loop = np.zeros_like(b[:, 0]), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    _assert_rel(got.numpy(), np.stack(loop, 1), 1e-5)


def test_softplus_is_jax_softplus():
    x = np.linspace(-60, 60, 2001).astype(np.float32)
    np.testing.assert_allclose(TM.softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("s,chunk", [(21, 8), (37, 256), (300, 256)])
def test_apply_mamba_matches_jax(s, chunk):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _weights(1)
    x = _x(2, s, s)
    want = np.asarray(JM.apply_mamba(pj, jnp.asarray(x), cfg_j,
                                     chunk=chunk))
    got = TM.apply_mamba(pt, torch.tensor(x), cfg_t, chunk=chunk)
    assert tuple(got.shape) == want.shape
    _assert_rel(got.numpy(), want)


def test_decode_matches_jax_step_for_step():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _weights(2)
    x = _x(2, 12, 5)
    cj = JM.init_mamba_cache(cfg_j, 2)
    ct = TM.init_mamba_cache(cfg_t, 2, device=CPU)
    step = jax.jit(lambda p, xx, c: JM.decode_mamba(p, xx, c, cfg_j))
    for t in range(x.shape[1]):
        oj, cj = step(pj, jnp.asarray(x[:, t:t + 1]), cj)
        ot, ct = TM.decode_mamba(pt, torch.tensor(x[:, t:t + 1]), ct, cfg_t)
        _assert_rel(ot.numpy(), np.asarray(oj), msg=f"out t={t}")
        for k in ("conv", "ssm"):
            _assert_rel(ct[k].numpy(), np.asarray(cj[k]), msg=f"{k} t={t}")


def test_decode_matches_full_sequence():
    _, cfg_t = _cfgs()
    _, pt = _weights(4)
    x = torch.tensor(_x(2, 19, 6))
    full = TM.apply_mamba(pt, x, cfg_t, chunk=8)
    cache = TM.init_mamba_cache(cfg_t, 2, device=CPU)
    outs = []
    for t in range(x.shape[1]):
        o, cache = TM.decode_mamba(pt, x[:, t:t + 1], cache, cfg_t)
        outs.append(o)
    _assert_rel(torch.cat(outs, 1).numpy(), full.numpy())


def test_vmap_grad_matches_per_client_loop():
    _, cfg_t = _cfgs()
    params = [TM.init_mamba(rng.PRNGKey(c), cfg_t, device=CPU)
              for c in range(2)]
    stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
    xs = torch.tensor(np.stack([_x(1, 11, c) for c in range(2)]))

    def loss(p, x):
        return (TM.apply_mamba(p, x, cfg_t, chunk=4) ** 2).mean()

    batched = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for c in range(2):
        one = torch.func.grad(loss)(params[c], xs[c])
        for k in one:
            np.testing.assert_allclose(batched[k][c].numpy(),
                                       one[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)

