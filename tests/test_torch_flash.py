"""The flash-attention kernel's plain version against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
oracle, over the JAX tests' sweep.  The CUDA kernel itself runs only on
a GPU (see tests/test_torch_gpu.py and chip_smoke.py)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jkops
from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

# fp32: sum order of fp32 products; bf16: one bf16 rounding of outputs
# of magnitude up to a few units
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(b, s, h, hd, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal((b, s, h, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,s,h,hd", [
    (1, 64, 1, 16), (2, 128, 4, 64), (1, 200, 2, 32), (2, 96, 3, 8),
])
@pytest.mark.parametrize("causal,window", [
    (True, 0), (False, 0), (True, 32),
])
def test_plain_flash_attention_matches_pallas(b, s, h, hd, causal, window,
                                              dtype):
    q, k, v = _qkv(b, s, h, hd, s * h + hd)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = np.asarray(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                   block_q=64, block_k=64, interpret=True),
                      np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    got = TOPS._flash_attention_torch(tq, tk, tv, causal=causal,
                                      window=window)
    assert got.dtype == tdt and got.shape == (b, s, h, hd)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        TREF.flash_attention_ref(tq, tk, tv, causal=causal,
                                 window=window).float().numpy(),
        np.asarray(JREF.flash_attention_ref(jq, jk, jv, causal=causal,
                                            window=window), np.float32),
        rtol=tol, atol=tol)


def test_ops_dispatch_on_cpu_uses_plain_version_and_never_launches():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 80, 2, 16, 0))
    got = TOPS.flash_attention(q, k, v, causal=True, window=16)
    want = TOPS._flash_attention_torch(q, k, v, causal=True, window=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert TOPS.flash_attention.launches == 0


def test_zero_padded_head_dim_keeps_the_attention():
    """The cuda route pads a head_dim that is not a multiple of 8 (qwen2-
    0.5b's smoke config has 28) with zero columns and scales by the true
    head_dim: the attention of the padded q, k, v, cut back to 28
    columns, is the attention of the unpadded ones (fp32 sum order)."""
    q, k, v = (torch.tensor(a) for a in _qkv(1, 96, 4, 28, 3))
    qp, kp, vp = (TOPS._pad_head_dim(t) for t in (q, k, v))
    assert qp.shape == (1, 96, 4, 32) and torch.equal(qp[..., :28], q)
    assert not qp[..., 28:].any()
    s = torch.einsum("bqhd,bkhd->bhqk", qp, kp) / 28 ** 0.5
    pos = torch.arange(96)
    s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    got = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vp)
    want = TOPS._flash_attention_torch(q, k, v, causal=True, window=0)
    np.testing.assert_allclose(got[..., :28].numpy(), want.numpy(),
                               rtol=0, atol=2e-6)
    assert not got[..., 28:].any()
    for hd in (32, 264):                       # taken, or refused, as is
        t = torch.zeros(1, 8, 1, hd)
        assert TOPS._pad_head_dim(t) is t


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_cuda(q, q, q, causal=True, window=0)


def test_aligned_copies_only_a_misaligned_view():
    """The kernel copies 16-byte chunks, so the wrapper hands it tensors
    that start on a 16-byte boundary: a view one bf16 element into its
    storage is copied, an aligned contiguous tensor passes as it is."""
    base = torch.zeros(1 + 2 * 8 * 16, dtype=torch.bfloat16)
    view = base[1:].view(1, 8, 2, 16)
    assert view.data_ptr() % 16
    fixed = TOPS._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    whole = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    assert TOPS._aligned(whole) is whole


def test_library_found_built_reads_back_its_ptxas_log(tmp_path, monkeypatch):
    """A library already built is loaded without nvcc and keeps the ptxas
    report written beside it at its build, so a later process still
    prints the registers and spills."""
    from repro_torch.kernels import build as BUILD
    lib = BUILD.CudaLibrary("flash_attention.cu", {
        "flash_attention": ([BUILD.P], BUILD.I)})
    assert lib.path().name.startswith("libflash_attention_")
    assert lib.path().parent == BUILD.BUILD_DIR
    monkeypatch.setattr(BUILD, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(BUILD, "_nvcc", lambda: pytest.fail("rebuilt"))
    monkeypatch.setattr(BUILD.ctypes, "CDLL", lambda path: SimpleNamespace(
        flash_attention=SimpleNamespace()))
    lib.path().write_bytes(b"")
    lib.path().with_suffix(".log").write_text("ptxas info: report")
    loaded = lib.load()
    assert loaded.flash_attention.restype is BUILD.I
    assert loaded.flash_attention.argtypes == [BUILD.P]
    assert lib.log == "ptxas info: report" and lib.build_s == 0.0


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,sq,sk,h,hd,causal,window", [
    # rows 263-299 see no key, and Sk 200 pads to 256 (at 100 or 128 the
    # padding would not show)
    (1, 300, 200, 2, 64, True, 64),
    (1, 300, 200, 2, 64, False, 64),
    # an Sk under the Pallas kernel's smallest key block (8)
    (2, 40, 5, 1, 8, True, 3)])
def test_plain_version_matches_pallas_on_rows_that_see_no_key(
        b, sq, sk, h, hd, causal, window, dtype):
    """Where every score of a row is -1e30 the Pallas kernel's p are all
    exp(0) = 1, the zero-padded keys of its key blocks included: the row
    is sum_{k<Sk} v_k / Sk_pad.  JAX's ``kops.flash_attention`` runs it
    interpreted here, with its own block rule."""
    g = np.random.default_rng(sq + sk)
    q, k, v = (g.standard_normal((b, s, h, hd)).astype(np.float32)
               for s in (sq, sk, sk))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = np.asarray(jkops.flash_attention(jq, jk, jv, causal=causal,
                                            window=window), np.float32)
    tdt = getattr(torch, dtype)
    got = TOPS._flash_attention_torch(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    empty = got[:, sk - 1 + window:].float().numpy()
    mean = v.sum(1) / TOPS.pallas_padded_keys(sk)
    assert TOPS.pallas_padded_keys(sk) > sk      # the padding counts
    np.testing.assert_allclose(empty, np.broadcast_to(
        mean[:, None], empty.shape), rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_version_takes_mixed_types_as_pallas_does():
    """A bf16 q against float32 K/V (a cross-attention over a float32
    encoder output): both upcast each input and write in q's type."""
    q, k, v = _qkv(1, 200, 2, 64, 3)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(jkops.flash_attention(jq, jnp.asarray(k),
                                            jnp.asarray(v), causal=False))
    got = TOPS._flash_attention_torch(torch.tensor(q).bfloat16(),
                                      torch.tensor(k), torch.tensor(v),
                                      causal=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jq.dtype
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
