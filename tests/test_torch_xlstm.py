"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the
JAX package's ``repro.models.xlstm`` on the CPU, at xlstm's smoke width
(d_model 128, 4 heads of 32) in float32.

Weights are JAX's, carried through numpy.  The chunkwise mLSTM and the
sequential sLSTM are held within 1e-5 of the largest output, with
sequence lengths off the chunk size; each decode recurrence is held to
JAX's step for step and to the port's own full-sequence form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import xlstm as JX
from repro_torch import rng
from repro_torch.configs import registry as TREG
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

ARCH = "xlstm-1.3b"
CPU = torch.device("cpu")
REL = 1e-5
KINDS = ("mlstm", "slstm")


def _cfgs():
    return JREG.get_smoke_config(ARCH), TREG.get_smoke_config(ARCH)


def _fns(mod, kind):
    return (getattr(mod, f"init_{kind}"), getattr(mod, f"apply_{kind}"),
            getattr(mod, f"init_{kind}_cache"),
            getattr(mod, f"decode_{kind}"))


def _weights(kind, seed=0):
    cfg_j, _ = _cfgs()
    p = _fns(JX, kind)[0](jax.random.PRNGKey(seed), cfg_j)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 128)).astype(np.float32)


def _assert_rel(got, want, rel=REL, msg=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (msg, err, scale)


@pytest.mark.parametrize("kind", KINDS)
def test_init_matches_jax(kind):
    """Shapes and types as JAX's (gates and recurrent matrices in
    float32), every leaf bit for bit: the constant biases and the drawn
    weights (XLA's erfinv, ``xla_math``)."""
    cfg_j, cfg_t = _cfgs()
    pj = _fns(JX, kind)[0](jax.random.PRNGKey(4), cfg_j)
    pt = _fns(TX, kind)[0](rng.PRNGKey(4), cfg_t, device=CPU)
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        a = np.asarray(v)
        assert tuple(pt[k].shape) == a.shape, k
        assert pt[k].dtype == torch.float32 and a.dtype == np.float32, k
        np.testing.assert_array_equal(pt[k].numpy(), a, err_msg=k)


def test_log_sigmoid_is_jax_log_sigmoid():
    x = np.linspace(-60, 60, 2001).astype(np.float32)
    np.testing.assert_allclose(
        TX.log_sigmoid(torch.tensor(x)).numpy(),
        np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("s,chunk", [(23, 8), (40, 256), (300, 256)])
def test_apply_mlstm_matches_jax(s, chunk):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _weights("mlstm", 1)
    x = _x(2, s, s)
    want = np.asarray(JX.apply_mlstm(pj, jnp.asarray(x), cfg_j,
                                     chunk=chunk))
    got = TX.apply_mlstm(pt, torch.tensor(x), cfg_t, chunk=chunk)
    _assert_rel(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 17])
def test_apply_slstm_matches_jax(s):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _weights("slstm", 2)
    x = _x(2, s, s + 1)
    want = np.asarray(JX.apply_slstm(pj, jnp.asarray(x), cfg_j))
    got = TX.apply_slstm(pt, torch.tensor(x), cfg_t)
    _assert_rel(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_jax_step_for_step(kind):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _weights(kind, 3)
    _, _, jcache, jdec = _fns(JX, kind)
    _, _, tcache, tdec = _fns(TX, kind)
    x = _x(2, 10, 7)
    cj, ct = jcache(cfg_j, 2), tcache(cfg_t, 2, device=CPU)
    step = jax.jit(lambda p, xx, c: jdec(p, xx, c, cfg_j))
    for t in range(x.shape[1]):
        oj, cj = step(pj, jnp.asarray(x[:, t:t + 1]), cj)
        ot, ct = tdec(pt, torch.tensor(x[:, t:t + 1]), ct, cfg_t)
        _assert_rel(ot.numpy(), np.asarray(oj), msg=f"out t={t}")
        for k in cj:
            _assert_rel(ct[k].numpy(), np.asarray(cj[k]), msg=f"{k} t={t}")


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_full_sequence(kind):
    _, cfg_t = _cfgs()
    _, pt = _weights(kind, 5)
    _, apply, tcache, tdec = _fns(TX, kind)
    x = torch.tensor(_x(2, 21, 8))
    kw = {"chunk": 8} if kind == "mlstm" else {}
    full = apply(pt, x, cfg_t, **kw)
    cache = tcache(cfg_t, 2, device=CPU)
    outs = []
    for t in range(x.shape[1]):
        o, cache = tdec(pt, x[:, t:t + 1], cache, cfg_t)
        outs.append(o)
    _assert_rel(torch.cat(outs, 1).numpy(), full.numpy())
