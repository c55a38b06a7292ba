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


def _tf32(x: torch.Tensor, mode: str = "rna") -> torch.Tensor:
    """float32 x with its 13 low mantissa bits dropped: rounded to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds
    (``"rna"``), or cut off, as the tensor core reads an operand that it
    is given unrounded (``"cut"``)."""
    b = x.float().contiguous().view(torch.int32)
    if mode == "rna":
        b = b + 0x1000
    return (b & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, split, lo_mode):
    """einsum(eq, a, b) of the TF32 parts, each product exact (float64,
    as the tensor core multiplies): a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
    with hi = tf32(x) and lo = tf32(x - hi) where ``split``, else one
    TF32 product a_hi.b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah.double(), bh.double())
    if split:
        al, bl = _tf32(a - ah, lo_mode), _tf32(b - bh, lo_mode)
        out = (torch.einsum(eq, al.double(), bh.double())
               + torch.einsum(eq, ah.double(), bl.double()) + out)
    return out


def _tf32_attention(q, k, v, causal, split, lo_mode="rna"):
    """Attention with both products taken from TF32 parts, as the float32
    kernel takes them (``split``) or as a kernel with one TF32 product
    would: q scaled in fp32 first, the softmax in fp32, p split again for
    P.V and l summed from the fp32 p."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[3]
    s = _tf32_product("bqhd,bkhd->bhqk", q * (1.0 / hd ** 0.5), k, split,
                      lo_mode).float()
    mask = TREF.attention_mask(torch.arange(sq), torch.arange(sk),
                               causal=causal, window=0)
    p = torch.exp(s.masked_fill(~mask, -1e30)
                  - s.masked_fill(~mask, -1e30).amax(-1, keepdim=True))
    out = _tf32_product("bhqk,bkhd->bqhd", p, v, split, lo_mode)
    return (out / p.sum(-1).transpose(1, 2)[..., None].double()).float()


def _exact_attention(q, k, v, causal):
    """The attention in float64 throughout."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / hd ** 0.5
    mask = TREF.attention_mask(torch.arange(sq), torch.arange(sk),
                               causal=causal, window=0)
    p = torch.softmax(s.masked_fill(~mask, -1e30), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())


@pytest.mark.parametrize("case", ["causal", "non-causal", "causal, q x 4",
                                  "causal, v = +-1 by key"])
def test_split_tf32_meets_the_fp32_bound_where_one_tf32_product_fails(case):
    """The float32 kernel's scheme, emulated at B 1, S 512, H 4, hd 64,
    against the fp32 bound of chip_smoke.py's FLASH_TOL (1e-4 absolute):
    every product from split TF32 parts (lo rounded as cvt.rna would
    round it, or cut off as the tensor core reads it) is within 0.05 of
    the bound of the float64 attention, and within 0.1 of it of the plain
    fp32 version ``ref.flash_attention_ref``, which is itself up to 0.051
    of the bound from float64 where q is scaled by 4 (its own fp32
    rounding of s); one TF32 product per product is over the bound."""
    b, s, h, hd = 1, 512, 4, 64
    q, k, v = (torch.tensor(a) for a in _qkv(b, s, h, hd, 24))
    if case == "causal, q x 4":
        q = q * 4
    if case == "causal, v = +-1 by key":
        sign = 1.0 - 2.0 * (torch.arange(s) % 2).float()
        v = sign.view(1, s, 1, 1).expand(b, s, h, hd).contiguous()
    causal = case != "non-causal"
    plain = TREF.flash_attention_ref(q, k, v, causal=causal).double()
    exact = _exact_attention(q, k, v, causal)
    bound = 1e-4

    def share(got, want):
        return float((got.double() - want).abs().max()) / bound

    for lo_mode in ("rna", "cut"):
        split = _tf32_attention(q, k, v, causal, True, lo_mode)
        assert share(split, exact) <= 0.05
        assert share(split, plain) <= 0.1
    assert share(_tf32_attention(q, k, v, causal, False), plain) > 1.0


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_away():
    """The emulation's rounding, on values whose 13 low bits are known:
    below half a unit rounds down, half a unit rounds away from zero, the
    cut drops the bits; signs and infinities keep."""
    one_ulp = 2.0 ** -10                      # a TF32 unit at 1.0
    x = torch.tensor([1.0 + one_ulp * 0.49, 1.0 + one_ulp * 0.5,
                      -(1.0 + one_ulp * 0.5), 1.0 + one_ulp * 0.99,
                      float("inf")], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, 1.0 + one_ulp, -(1.0 + one_ulp),
                                 1.0 + one_ulp, float("inf")]
    assert _tf32(x, "cut").tolist() == [1.0, 1.0, -1.0, 1.0, float("inf")]


def test_another_trees_source_gets_a_library_of_its_own(tmp_path):
    """A copy of a source outside csrc/ (another tree's, as a timing
    script builds it) is named by its content: the same bytes share the
    default build, an edited copy never reuses it."""
    from repro_torch.kernels import build as BUILD
    sig = {"flash_attention": ([BUILD.P], BUILD.I)}
    default = BUILD.CudaLibrary("flash_attention.cu", sig)
    same = tmp_path / "same" / "flash_attention.cu"
    edited = tmp_path / "edited" / "flash_attention.cu"
    for path in (same, edited):
        path.parent.mkdir()
        path.write_bytes(default.source.read_bytes())
    edited.write_text(edited.read_text() + "\n// another tree\n")
    copy = BUILD.CudaLibrary(str(same), sig)
    other = BUILD.CudaLibrary(str(edited), sig)
    assert copy.source == same and other.source == edited
    assert copy.path() == default.path()
    assert other.path() != default.path()
    assert other.path().parent == default.path().parent == BUILD.BUILD_DIR

