"""Uneven splits padded to the 'model' axis, as GSPMD pads them, held to
the unsplit path by value.

Inside the dry run's mesh the port pads query heads that the 'model' axis
does not divide (qwen2's 14, whisper's 6 over 16) to the next multiple,
where the split is made (``sharding.constrain.pad_split``): ``wq``/``bq``
get zero columns for the padded heads, ``wk``/``wv`` (and their biases)
each query head's KV head (the expanded K/V), ``wo`` zero rows; a vocab
it does not divide (whisper's 51,865) pads ``w_head`` with zero columns
that the loss drops as -inf.

Here a 2 x 2 (data, model) mesh over four CPU processes (a gloo group:
the vocab-sharded loss reduces its max and sum across ranks, which a fake
group would not carry) runs qwen2's smoke attention at 3 heads of 32, one
KV head, and a 255-token vocab: 3 heads pad to 4, 2 a rank, the second
rank's second head padded.  Each rank holds its shard of the inputs and
parameters as the dry run's rules place them; each compares its shard
of every output and gradient (gathered) with the unsplit path's on plain
tensors, within 1e-6 of the largest value, and checks that the padded
heads' q, k, v, their gradients and the attention's output there are
exact zeros.  No JAX import: the file runs on a host without it."""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6

WORKER = r'''
import json, sys, torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.sharding import rules as R
from repro_torch.sharding.constrain import use_mesh

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
AXES = {"data": 2, "model": 2}
cfg = get_smoke_config("qwen2-0.5b").replace(
    num_heads=3, num_kv_heads=1, d_model=96, vocab_size=255,
    dtype="float32")
H, KV, HD, D, V = 3, 1, 32, 96, 255
B, S, LONG, SE, EFF, POS = 4, 40, 1100, 24, 16, 9
mrank = mesh.get_local_rank(1)                  # the 'model' coordinate
g = torch.Generator().manual_seed(0)


def rnd(*shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


W = D ** -0.5
P = {"wq": rnd(D, H * HD, scale=W), "wk": rnd(D, KV * HD, scale=W),
     "wv": rnd(D, KV * HD, scale=W), "wo": rnd(H * HD, D, scale=W),
     "bq": rnd(H * HD, scale=0.1), "bk": rnd(KV * HD, scale=0.1),
     "bv": rnd(KV * HD, scale=0.1)}
SPECS = {"wq": ("data", "model"), "wk": ("data", "model"),
         "wv": ("data", "model"), "wo": ("model", "data"),
         "bq": ("model",), "bk": ("model",), "bv": ("model",)}
X = {"short": rnd(B, S, D), "long": rnd(B, LONG, D), "enc": rnd(B, SE, D)}
COT = {"short": rnd(B, S, D), "long": rnd(B, LONG, D), "cross": rnd(B, S, D)}
CACHE = {"k": rnd(B, EFF, KV, HD), "v": rnd(B, EFF, KV, HD)}
XD = rnd(B, 1, D)
XF, WH = rnd(B, S, D), rnd(D, V, scale=D ** -0.5)
LAB = torch.randint(0, V, (B, S), generator=g)
MASK = (torch.rand(B, S, generator=g) > 0.3).float()
ROWS = slice(0, 2) if mesh.get_local_rank(0) == 0 else slice(2, 4)
res = {"errs": {}, "zeros": {}}


def placed(t, spec, grad=True):
    spec = R.sanitize_specs({"t": spec}, {"t": t}, AXES)["t"]
    d = distribute_tensor(t.detach().clone(), mesh, R.placements(spec, mesh))
    return d.requires_grad_(grad) if t.is_floating_point() else d


def err(name, got, want, scale=None):
    got = got.full_tensor() if isinstance(got, DTensor) else got
    scale = want.abs().max() if scale is None else scale
    res["errs"][name] = float((got - want).abs().max() / scale)


captured = {}


def capture(fn, key):
    def wrapped(q, k, v, **kw):
        for n, t in zip("qkv", (q, k, v)):
            t.retain_grad()
            captured[key + n] = t
        out = fn(q, k, v, **kw)
        captured[key + "o"] = out
        return out
    return wrapped


L.naive_attention = capture(L.naive_attention, "naive_")
L.chunked_attention = capture(L.chunked_attention, "chunked_")


def plain_params():
    return {k: v.clone().requires_grad_(True) for k, v in P.items()}


def train_case(name, x, cot, **kw):
    """attention_train on plain tensors and on the mesh: the output, and
    the gradients of x (and the encoder output), the weights and the
    biases, and the q, k, v entering the attention."""
    key = "chunked_" if x.shape[1] > 1024 else "naive_"
    pp = plain_params()
    xp = x.clone().requires_grad_(True)
    enc_p = X["enc"].clone().requires_grad_(True) if name == "cross" else None
    if enc_p is not None:
        kw["kv_override"] = L.kv_proj(pp, enc_p, cfg)
    want = L.attention_train(pp, xp, cfg, **kw)
    want_qkv = {n: captured[key + n] for n in "qkv"}
    leaves = [xp, *pp.values()] + ([enc_p] if enc_p is not None else [])
    wgrads = torch.autograd.grad(want, leaves + list(want_qkv.values()), cot)
    with use_mesh(mesh):
        pm = {k: placed(v, SPECS[k]) for k, v in P.items()}
        xm = placed(x, ("data", None, None))
        enc_m = placed(X["enc"], ("data", None, None)) \
            if name == "cross" else None
        if enc_m is not None:
            kw["kv_override"] = L.kv_proj(pm, enc_m, cfg)
        out = L.attention_train(pm, xm, cfg, **kw)
        got_qkv = {n: captured[key + n] for n in "qkv"}
        out = out.redistribute(mesh, [Shard(0), Replicate()])
        out.backward(placed(cot, ("data", None, None), grad=False))
    err(f"{name}/out", out, want)
    mleaves = [xm, *pm.values()] + ([enc_m] if enc_m is not None else [])
    names = ["x", *P] + (["enc"] if enc_m is not None else [])
    scales = dict(zip(names, (w.abs().max() for w in wgrads)))
    for n, m, w in zip(names, mleaves, wgrads):
        # a bias's gradient on its weight's scale: the cross attention's
        # dbk is zero but for rounding (adding one vector to every key
        # shifts a row's scores alike, which the softmax ignores)
        err(f"{name}/d{n}", m.grad, w, scales.get("w" + n[1:])
            if n.startswith("b") else None)
    # each rank's heads: 2 of the 4 padded ones, the rank's global heads
    heads = [h for h in (2 * mrank, 2 * mrank + 1)]
    for i, n in enumerate("qkv"):
        loc = got_qkv[n].to_local()
        gloc = got_qkv[n].grad.to_local()
        want_t, want_g = want_qkv[n][ROWS], wgrads[len(leaves) + i][ROWS]
        for j, h in enumerate(heads):
            if h < H:
                err(f"{name}/{n}[h{h}]", loc[:, :, j], want_t[:, :, h])
                err(f"{name}/d{n}[h{h}]", gloc[:, :, j], want_g[:, :, h])
            else:
                res["zeros"][f"{name}/{n}"] = bool(
                    (loc[:, :, j] == 0).all() and (gloc[:, :, j] == 0).all())
                res["zeros"][f"{name}/o"] = bool(
                    (captured[key + "o"].to_local()[:, :, j] == 0).all())


def decode_case(name, cross):
    """attention_decode against the cache (the self cache updated at
    POS; the cross one split over 'model' along the sequence, as the
    rules place a cache whose KV heads do not divide the axis)."""
    cache = {k: v.clone() for k, v in CACHE.items()}
    with torch.no_grad():
        want, cache = L.attention_decode(P, XD, cache, POS, cfg, cross=cross)
        with use_mesh(mesh):
            pm = {k: placed(v, SPECS[k], grad=False) for k, v in P.items()}
            spec = ("data", "model" if cross else None, None, None)
            cm = {k: placed(v, spec, grad=False) for k, v in CACHE.items()}
            out, cm = L.attention_decode(pm, placed(XD, ("data", None, None),
                                                    grad=False),
                                         cm, POS, cfg, cross=cross)
    err(f"{name}/out", out, want)
    if not cross:
        err(f"{name}/cache_k", cm["k"], cache["k"])


def xent_case():
    """chunked_softmax_xent with the vocab padded to 256: the loss and
    the gradients of x and w_head; the padded column at -inf."""
    xp, wp = XF.clone().requires_grad_(True), WH.clone().requires_grad_(True)
    want = L.chunked_softmax_xent(None, xp, wp, LAB, MASK, chunk=8)
    wgrads = torch.autograd.grad(want, (xp, wp))
    logits = []
    drop = L._drop_padding
    L._drop_padding = lambda t, v: logits.append(drop(t, v)) or logits[-1]
    with use_mesh(mesh):
        xm = placed(XF, ("data", None, None))
        wm = placed(WH, ("data", "model"))
        loss = L.chunked_softmax_xent(
            None, xm, wm, placed(LAB, ("data", None)),
            placed(MASK, ("data", None), grad=False), chunk=8)
        loss.backward()
    L._drop_padding = drop
    err("xent/loss", loss, want)
    err("xent/dx", xm.grad, wgrads[0])
    err("xent/dw", wm.grad, wgrads[1])
    res["logits_local_vocab"] = logits[0].to_local().shape[-1]
    col = logits[0].to_local()[..., -1]
    res["zeros"]["xent/padded_column_at_-inf"] = bool(
        (col == float("-inf")).all()) if mrank == 1 else True


train_case("short", X["short"], COT["short"])
train_case("long", X["long"], COT["long"])
train_case("cross", X["short"], COT["cross"], causal=False)
decode_case("decode", False)
decode_case("decode_cross", True)
xent_case()
dist.destroy_process_group()
print("RESULT " + json.dumps(res))
'''


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' results, each in a process of its own."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(4)]
        outs = [p.communicate(timeout=600) for p in procs]
    res = []
    for p, (out, errs) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:] + errs[-3000:]
        line = next(l for l in out.splitlines() if l.startswith("RESULT "))
        res.append(json.loads(line[len("RESULT "):]))
    return res


CASES = ("short", "long", "cross", "decode", "decode_cross", "xent")


@pytest.mark.parametrize("case", CASES)
def test_each_rank_matches_the_unsplit_path(ranks, case):
    """Every output and gradient of the case, and each real head's q, k,
    v and their gradients on the rank that holds it, within 1e-6 of the
    unsplit path's largest value (a sum split over ranks may add in
    another order)."""
    for r, res in enumerate(ranks):
        errs = {k: v for k, v in res["errs"].items()
                if k.split("/")[0] == case}
        assert errs, (r, case)
        for name, e in errs.items():
            assert e <= REL, (r, name, e)


def test_padded_heads_and_vocab_are_exact_zeros(ranks):
    """On the 'model' rank that holds the padded head, its q, k, v, their
    gradients and the attention's output there are exact zeros, in the
    naive (S 40), chunked (S 1,100) and cross attention; the padded
    vocab column enters the loss at -inf."""
    for r, res in enumerate(ranks):
        assert res["zeros"] and all(res["zeros"].values()), (r, res["zeros"])
    assert {k for r in ranks[1::2] for k in r["zeros"]} >= {
        f"{c}/{n}" for c in ("short", "long", "cross") for n in "qkvo"}


def test_each_rank_holds_half_the_padded_vocab(ranks):
    """The logits chunk a rank holds is 128 of the 256 padded columns, not
    the whole vocab."""
    assert {r["logits_local_vocab"] for r in ranks} == {128}
