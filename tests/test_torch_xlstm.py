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


# ----------------------------------------------------------------------
# the mLSTM inside the mesh: v's head_dim split over 'model', as JAX's;
# per-chunk recompute under remat
# ----------------------------------------------------------------------

MESH_RUN = """
import json, torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import xlstm as X
from repro_torch.sharding.constrain import use_mesh
B, h, S, dh, chunk = 4, 4, 40, 32, 16
g = torch.Generator().manual_seed(0)
q, k, v, cot = (torch.randn(B, h, S, dh, generator=g) for _ in range(4))
li = torch.randn(B, h, S, generator=g)
lf = torch.nn.functional.logsigmoid(torch.randn(B, h, S, generator=g) + 3)
ins = (q, k, v, li, lf)
rows = slice(0, B // 2)

def unsplit(cot):
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out = X._mlstm_chunks(*leaves, chunk)
    return out.detach(), torch.autograd.grad(out, leaves, cot)

mesh = fake_mesh((2, 2), ("data", "model"), "cpu")
REP, SPLIT = [Shard(0), Replicate()], [Shard(0), Shard(3)]

def placed(t, pl, cols=None):
    local = t[rows] if cols is None else t[rows][..., cols]
    local = local.clone().requires_grad_(True)
    return local, DTensor.from_local(local, mesh, pl, run_check=False,
                                     shape=t.shape, stride=t.stride())

res = {}
want, _ = unsplit(cot)
halves = (slice(0, dh // 2), slice(dh // 2, dh))
with use_mesh(mesh):
    # v given whole over 'model': the loop splits it, its output too
    dts = [placed(t, REP)[1] for t in ins]
    out = X._mlstm_loop(*dts, chunk, False)
    res["placements"] = [p.dim if p.is_shard() else None
                         for p in out.placements]
    res["local_shape"] = list(out.to_local().shape)
    # each 'model' shard of v's columns: its output columns and grads,
    # q's, k's and the gates' a partial sum over the shards
    parts = []
    for cols in halves:
        locs, dts = zip(*[placed(t, SPLIT, cols) if t is v else
                          placed(t, REP) for t in ins])
        for recompute in (False, True):
            out = X._mlstm_loop(*dts, chunk, recompute)
            c = cot[rows][..., cols]
            grads = torch.autograd.grad(out.to_local(), locs, c)
            parts.append((cols, recompute, out.to_local().detach(), grads))
_, full = unsplit(cot)
err = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0, "dli": 0.0, "dlf": 0.0}
scale = {"out": want.abs().max().item()}
scale.update({n: full[i][rows].abs().max().item()
              for i, n in enumerate(("dq", "dk", "dv", "dli", "dlf"))})
for recompute in (False, True):
    summed = [0, 0, None, 0, 0]
    for cols, rc, out, grads in parts:
        if rc != recompute:
            continue
        err["out"] = max(err["out"], (out - want[rows][..., cols]).abs().max().item())
        err["dv"] = max(err["dv"], (grads[2] - full[2][rows][..., cols]).abs().max().item())
        for i in (0, 1, 3, 4):
            summed[i] = summed[i] + grads[i]
    for i, n in ((0, "dq"), (1, "dk"), (3, "dli"), (4, "dlf")):
        err[n] = max(err[n], (summed[i] - full[i][rows]).abs().max().item())
res["rel_err"] = {n: err[n] / scale[n] for n in err}
res["recompute_bit_identical"] = all(
    torch.equal(a[2], b[2]) and all(torch.equal(x, y) for x, y in zip(a[3], b[3]))
    for a, b in zip(parts[0::2], parts[1::2]))
dist.destroy_process_group()
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def mesh_result():
    """MESH_RUN in a process of its own (the fake process group meets no
    other test)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", MESH_RUN], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    line = next(l for l in p.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_mlstm_on_the_mesh_splits_v_head_dim(mesh_result):
    """On a 2 x 2 fake mesh the loop's output comes back split as v's
    head_dim, over 'model' (JAX's ``maybe_constrain(v, 'data', None,
    None, 'model')``): rows over 'data', dh / 2 = 16 columns a shard."""
    assert mesh_result["placements"] == [0, 3]     # Shard(0), Shard(3)
    assert mesh_result["local_shape"] == [2, 4, 40, 16]


def test_mlstm_on_the_mesh_matches_the_unsplit_path(mesh_result):
    """Each 'model' shard's output columns and v's gradient there are the
    unsplit path's, and q's, k's and the gates' gradients summed over the
    two shards (the partial sums DTensor reduces) are the unsplit
    path's, within 1e-6 of the largest (another product shape may sum
    in another order); with per-chunk recompute the same bits."""
    for name, err in mesh_result["rel_err"].items():
        assert err <= 1e-6, (name, err)
    assert mesh_result["recompute_bit_identical"]


GATES = ("wi", "wf", "bi", "bf")              # float32 in every config


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_per_chunk_recompute_is_bit_identical(dtype, monkeypatch):
    """Under ``cfg.remat`` each chunk's step runs again in the backward
    (a chunk step a chunk in the forward and another in the backward),
    and the output and every gradient are the plain path's bit for bit."""
    _, cfg_t = _cfgs()
    _, pt = _weights("mlstm", 6)
    dt = getattr(torch, dtype)
    x = torch.tensor(_x(2, 45, 9)).to(dt)
    cot = torch.tensor(_x(2, 45, 10)).to(dt)
    step, calls = TX._mlstm_step, []
    monkeypatch.setattr(TX, "_mlstm_step",
                        lambda *a: calls.append(1) or step(*a))
    got = {}
    for remat in (False, True):
        calls.clear()
        p = {k: v.to(torch.float32 if k in GATES else dt)
             .requires_grad_(True) for k, v in pt.items()}
        xx = x.clone().requires_grad_(True)
        out = TX.apply_mlstm(p, xx, cfg_t.replace(dtype=dtype, remat=remat),
                             chunk=8)
        out.backward(cot)
        got[remat] = (out.detach(), xx.grad, [p[k].grad for k in sorted(p)])
        assert len(calls) == (12 if remat else 6), (remat, len(calls))
    a, b = got[False], got[True]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(u, w) for u, w in zip(a[2], b[2]))
