"""The CUDA kernels (lloyd_step, kmeans_assign, flash_attention) against
their plain versions on the card, the batched cohort runtimes on the
card against the same runtimes on the CPU, the LM training path's
two hand-written backwards and transformer FL on the card against the
CPU, and the MoE, Mamba and xLSTM blocks and their archs' decode on the
card against the CPU.

Marked ``gpu``: it needs a CUDA device and nvcc, and skips elsewhere
(the decision is made inside the fixture, never at import).  Run it on a
GPU machine with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``;
``python3 chip_smoke.py`` makes the same comparisons at the main paths'
shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TOPS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,f,k,r,dtype", [
    (100, 256, 10, 4, torch.float32), (257, 100, 7, 1, torch.float32),
    (33, 33, 3, 2, torch.float32), (4096, 256, 16, 1, torch.bfloat16),
    (300, 40, 128, 1, torch.float32),
    # many 128-row chunks: the update writes partial sums and a reduce
    # adds them
    (70_000, 64, 10, 4, torch.float32),
    # one row, and rows under one warp group (16 rows)
    (1, 256, 10, 4, torch.float32), (31, 256, 10, 4, torch.float32),
    # 512 (restart, centroid) pairs: 64 groups of 8 a warp; F over one
    # 256-feature chunk
    (200, 300, 128, 4, torch.float32)])
def test_kernel_matches_plain_version(cuda, n, f, k, r, dtype):
    g = torch.Generator(device="cpu").manual_seed(n * f + k)
    x = torch.randn(n, f, generator=g).to(cuda, dtype)
    c = torch.randn(r, k, f, generator=g).to(cuda)
    before = TOPS.lloyd_step.launches
    lab, dist, sums, counts = TOPS.lloyd_step(x, c)
    torch.cuda.synchronize()
    assert TOPS.lloyd_step.launches == before + 1
    lab_p, dist_p, _, _ = TOPS._lloyd_step_torch(x.cpu(), c.cpu())
    xd, cd = x.double().cpu(), c.double().cpu()
    d = torch.stack([((xd[:, None, :] - cd[i][None]) ** 2).sum(-1)
                     for i in range(r)])                   # (R, N, K) exact
    best2 = d.topk(2, dim=2, largest=False).values
    clear = (best2[..., 1] - best2[..., 0]) > 1e-4 * best2[..., 0].abs()
    lab = lab.cpu()
    assert (lab[clear] == lab_p[clear]).all()
    # off the clear rows the kernel's label is a nearest one by distance
    picked = torch.gather(d, 2, lab.long()[..., None])[..., 0]
    assert torch.allclose(picked, best2[..., 0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dist.cpu().numpy(), dist_p.numpy(),
                               rtol=1e-4, atol=1e-3)
    onehot = torch.nn.functional.one_hot(lab.long(), k).float()
    xs = x.float().cpu()
    np.testing.assert_allclose(sums.cpu().numpy(),
                               (onehot.transpose(1, 2) @ xs).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  onehot.sum(1).numpy())
    # deterministic: no atomics, a fixed reduction order
    again = TOPS.lloyd_step(x, c)
    for a, b in zip((lab, dist, sums, counts), again):
        assert torch.equal(a.cpu(), b.cpu())


def _near_tie_ok(x, c, lab, lab_p):
    """Labels equal off near-ties; everywhere nearest by exact distance."""
    d = ((x.double().cpu()[:, None] - c.double().cpu()[None]) ** 2).sum(-1)
    best2 = d.topk(2, dim=1, largest=False).values
    clear = (best2[:, 1] - best2[:, 0]) > 1e-4 * best2[:, 0].abs()
    lab = lab.cpu()
    assert (lab[clear] == lab_p.cpu()[clear]).all()
    picked = d.gather(1, lab.long()[:, None])[:, 0]
    assert torch.allclose(picked, best2[:, 0], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,f,k", [(16, 8, 2), (100, 64, 10), (257, 256, 7),
                                   (512, 100, 16), (33, 33, 3),
                                   (70_000, 64, 10), (300, 40, 128),
                                   (1, 256, 10), (31, 256, 10),
                                   (200, 300, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_assign_kernel_matches_plain_version(cuda, n, f, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(n * f + k)
    x = torch.randn(n, f, generator=g).to(cuda, dtype)
    c = torch.randn(k, f, generator=g).to(cuda)
    before = TOPS.kmeans_assign.launches
    lab, dist = TOPS.kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert TOPS.kmeans_assign.launches == before + 1
    assert lab.dtype == torch.int32 and dist.dtype == torch.float32
    lab_p, dist_p = TOPS._kmeans_assign_torch(x, c)
    _near_tie_ok(x, c, lab, lab_p)
    np.testing.assert_allclose(dist.cpu().numpy(), dist_p.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [100, 70_000])
def test_kernel_keeps_permuted_restarts_bit_identical(cuda, n):
    """Restart 1 holds restart 0's centroids under permuted ids, so it
    reaches the same partition: the kernel gives it the same distances,
    sums and counts to the bit (stage 1's best-restart argmin relies on
    such exact ties, as the JAX package does).  N 70,000 runs the reduce
    over row chunks."""
    f, k = 256, 10
    g = torch.Generator(device="cpu").manual_seed(n + 5)
    x = torch.randn(n, f, generator=g).to(cuda)
    perm = torch.randperm(k, generator=g)
    inv_perm = torch.argsort(perm)
    c0 = torch.randn(k, f, generator=g)
    c = torch.stack([c0, c0[perm]]).to(cuda)            # c[1] = c[0][perm]
    lab, dist, sums, counts = (t.cpu() for t in TOPS.lloyd_step(x, c))
    assert torch.equal(lab[1], inv_perm.int()[lab[0].long()])
    assert torch.equal(dist[1], dist[0])
    assert torch.equal(sums[1], sums[0][perm])
    assert torch.equal(counts[1], counts[0][perm])


# bf16 bound (see FLASH_TOL in chip_smoke.py): the kernel and the plain
# version compute in fp32 (the bf16 kernel carries p as two bf16 terms,
# about 16 bits) and round to bf16 at most one unit apart
BF16_RTOL = 2.0 ** -7


def _check_flash(cuda, q, k, v, causal, window):
    before = TOPS.flash_attention.launches
    out = TOPS.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert TOPS.flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    want = TOPS._flash_attention_torch(q, k, v, causal=causal, window=window)
    rtol = 0.0 if q.dtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=1e-4)
    # deterministic: no atomics, a fixed order of every sum
    again = TOPS.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(out, again)
    return want


@pytest.mark.parametrize("b,sq,sk,h,hd,dtype,causal,window", [
    (1, 64, 64, 1, 16, torch.float32, True, 0),
    (2, 128, 128, 4, 64, torch.float32, False, 0),
    (1, 200, 200, 2, 32, torch.float32, True, 32),
    (2, 96, 96, 3, 8, torch.float32, True, 0),
    (2, 1100, 1100, 3, 96, torch.float32, False, 0),
    (1, 130, 130, 2, 256, torch.float32, True, 0),
    (1, 70, 150, 2, 40, torch.float32, False, 0),
    (1, 150, 70, 2, 16, torch.float32, True, 0),
    (1, 200, 200, 2, 32, torch.float32, False, 48),
    (1, 300, 300, 2, 128, torch.bfloat16, True, 100),
    (1, 1031, 1031, 14, 64, torch.bfloat16, True, 0),
    # the tensor-core path: a padded contraction (hd 8, 40, 96 are not
    # multiples of 16 or of the accumulator's width) and the wide
    # accumulator with 32-key tiles (hd 256)
    (2, 96, 96, 3, 8, torch.bfloat16, True, 0),
    (1, 200, 200, 2, 40, torch.bfloat16, False, 0),
    (1, 260, 260, 4, 96, torch.bfloat16, True, 0),
    (1, 130, 130, 2, 256, torch.bfloat16, True, 0),
    (1, 300, 300, 2, 256, torch.bfloat16, False, 70),
    # Sq != Sk both ways, off the 64-row and 64-key tiles
    (1, 70, 150, 2, 40, torch.bfloat16, False, 0),
    (1, 100, 333, 3, 64, torch.bfloat16, True, 0),
    (1, 150, 70, 2, 64, torch.bfloat16, True, 0),
    (1, 333, 100, 2, 128, torch.bfloat16, False, 0),
    # causal with B 2 and many heads
    (2, 520, 520, 16, 64, torch.bfloat16, True, 0),
    # windows whose edge falls inside a key tile
    (1, 400, 400, 2, 64, torch.bfloat16, True, 77),
    (1, 300, 300, 3, 128, torch.bfloat16, False, 100),
    # the split-TF32 fp32 kernel: each instantiation (hd 64 with 64-key
    # tiles and Q in registers, hd 96, 128 and 256 with 32-key tiles and
    # Q split from shared memory, hd 120 and 200 padded), Sq != Sk both
    # ways, and windows whose edge falls inside a key tile
    (1, 260, 260, 4, 96, torch.float32, True, 0),
    (1, 70, 150, 2, 96, torch.float32, False, 0),
    (1, 100, 333, 3, 64, torch.float32, True, 0),
    (1, 150, 70, 2, 64, torch.float32, True, 0),
    (1, 333, 100, 2, 128, torch.float32, False, 0),
    (1, 100, 333, 2, 128, torch.float32, True, 0),
    (1, 400, 400, 2, 64, torch.float32, True, 77),
    (1, 300, 300, 3, 128, torch.float32, False, 100),
    (1, 300, 300, 2, 256, torch.float32, False, 70),
    (2, 520, 520, 16, 64, torch.float32, True, 0),
    (1, 200, 200, 2, 120, torch.float32, False, 0),
    (1, 200, 200, 2, 200, torch.float32, True, 45),
    # qwen2-0.5b's smoke head_dim 28: the wrapper zero-pads it to 32
    (1, 200, 200, 4, 28, torch.float32, True, 0),
    (1, 1100, 1100, 4, 28, torch.bfloat16, True, 0)])
def test_flash_kernel_matches_plain_version(cuda, b, sq, sk, h, hd, dtype,
                                            causal, window):
    """fp32 at 1e-4 absolute (sum order of fp32 products); bf16 at 1e-4
    plus 2^-7 of each value (the two fp32 results round to at most one
    bf16 unit apart, and a unit is at most 2^-7 of the value)."""
    g = torch.Generator(device="cpu").manual_seed(sq * h + hd)
    q = torch.randn(b, sq, h, hd, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, sk, h, hd, generator=g).to(cuda, dtype)
            for _ in range(2))
    _check_flash(cuda, q, k, v, causal, window)


def test_flash_kernel_keeps_p_precise_where_early_causal_rows_cancel(cuda):
    """v alternates +1 / -1 over the keys, so an early causal row's output
    is a small difference of a few p.  The kernel meets the bf16 bound;
    the same attention with p rounded once to bf16 before P.V (a single
    bf16 P) does not, which shows that the case tells the two apart."""
    b, s, h, hd = 1, 256, 8, 64
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k = (torch.randn(b, s, h, hd, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    sign = 1.0 - 2.0 * (torch.arange(s, device=cuda) % 2)
    v = sign.view(1, s, 1, 1).expand(b, s, h, hd).to(torch.bfloat16)
    v = v.contiguous()
    want = _check_flash(cuda, q, k, v, True, 0).float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
    pos = torch.arange(s, device=cuda)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    single = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(),
                          v.float()) / p.sum(-1).transpose(1, 2)[..., None]
    single = single.to(torch.bfloat16).float()
    share = ((single - want).abs() / (1e-4 + BF16_RTOL * want.abs())).max()
    assert float(share) > 1.0


def _tf32(x):
    """float32 x rounded to TF32 (10 stored mantissa bits, to nearest with
    ties away from zero, as cvt.rna.tf32.f32 rounds)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def test_flash_fp32_kernel_keeps_products_precise_where_one_tf32_product_fails(
        cuda):
    """Causal rows with q scaled by 4 (sharp softmaxes, so an error in s
    shows in p): the float32 kernel, whose products are split TF32 (three
    TF32 products each), meets the fp32 bound (0.0, 1e-4); the same
    attention with q * scale, k, p and v each rounded once to TF32 and
    exact products (one TF32 product per product, as a kernel that does
    not split would compute) exceeds it more than tenfold, which shows
    that the case tells the two apart."""
    b, s, h, hd = 1, 512, 4, 64
    g = torch.Generator(device="cpu").manual_seed(24)
    q = (4 * torch.randn(b, s, h, hd, generator=g)).to(cuda)
    k, v = (torch.randn(b, s, h, hd, generator=g).to(cuda) for _ in range(2))
    want = _check_flash(cuda, q, k, v, True, 0).double()
    sc = torch.einsum("bqhd,bkhd->bhqk", _tf32(q * (1.0 / hd ** 0.5)).double(),
                      _tf32(k).double()).float()
    pos = torch.arange(s, device=cuda)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    single = torch.einsum("bhqk,bkhd->bqhd", _tf32(p).double(),
                          _tf32(v).double())
    single = single / p.sum(-1).transpose(1, 2)[..., None].double()
    assert float((single - want).abs().max()) / 1e-4 > 10.0


@pytest.mark.parametrize("b,sq,sk,h,hd,dtype,causal,window", [
    # rows 263-299 see no key; Sk 200 pads to 256 in the Pallas kernel
    (1, 300, 200, 2, 64, torch.float32, True, 64),
    (1, 300, 200, 2, 64, torch.bfloat16, True, 64),
    (1, 300, 200, 2, 64, torch.bfloat16, False, 64),
    (1, 300, 200, 2, 96, torch.float32, True, 64),
    # a whole query tile of such rows (every key tile skipped), hd 96
    # and 256, and an Sk under the Pallas kernel's smallest block
    (2, 400, 130, 3, 96, torch.bfloat16, True, 8),
    (1, 200, 100, 2, 256, torch.bfloat16, True, 16),
    (1, 40, 5, 1, 8, torch.float32, True, 3)])
def test_flash_kernel_gives_pallas_result_on_rows_that_see_no_key(
        cuda, b, sq, sk, h, hd, dtype, causal, window):
    """A row q >= Sk - 1 + window gets sum_{k<Sk} v_k / Sk_pad, as the
    Pallas kernel does (and the plain version, held to it on the CPU)."""
    g = torch.Generator(device="cpu").manual_seed(sq + sk + hd)
    q = torch.randn(b, sq, h, hd, generator=g).to(cuda, dtype)
    k, v = (torch.randn(b, sk, h, hd, generator=g).to(cuda, dtype)
            for _ in range(2))
    assert sq >= sk + window          # some rows see no key
    want = _check_flash(cuda, q, k, v, causal, window)
    empty = want[:, sk - 1 + window:].float()
    mean = v.float().sum(1) / TOPS.pallas_padded_keys(sk)
    torch.testing.assert_close(empty, mean[:, None].expand_as(empty).to(
        dtype).float(), rtol=0, atol=0)


@pytest.mark.parametrize("q_dtype,kv_dtype,causal", [
    (torch.bfloat16, torch.float32, False),
    (torch.bfloat16, torch.float32, True),
    (torch.float32, torch.bfloat16, False)])
def test_flash_kernel_takes_mixed_types_as_pallas_does(cuda, q_dtype,
                                                       kv_dtype, causal):
    """A bf16 q against float32 K/V (the cross-attention over a float32
    encoder output) runs the float32 kernel on the upcast inputs and
    returns q's type; the plain version upcasts alike."""
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn(1, 1100, 6, 64, generator=g).to(cuda, q_dtype)
    k, v = (torch.randn(1, 700, 6, 64, generator=g).to(cuda, kv_dtype)
            for _ in range(2))
    before = TOPS.flash_attention.launches
    out = TOPS.flash_attention(q, k, v, causal=causal, window=0)
    assert TOPS.flash_attention.launches == before + 1
    assert out.dtype == q_dtype and out.shape == q.shape
    want = TOPS._flash_attention_torch(q, k, v, causal=causal, window=0)
    rtol = 0.0 if q_dtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=1e-4)


@pytest.mark.parametrize("hd", [264])
def test_flash_kernel_refuses_head_dims_it_does_not_take(cuda, hd):
    q = torch.zeros(1, 8, 1, hd, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TOPS.flash_attention(q, q, q, causal=True, window=0)


# the batched runtimes at tests/test_sim.py's size: their stage-3
# aggregate and stage-1 gradient features on the card against the same
# runtime on the CPU, within the reference's bound between runtimes
RUNTIME_KW = dict(num_clients=10, num_clusters=3, select_ratio=0.4,
                  rounds=2, local_epochs=2, sample_window=10,
                  cluster_resamples=2, init_energy_mode="normal", seed=3)


@pytest.mark.parametrize("runtime", ["vectorized", "sharded", "device"])
def test_batched_runtime_on_cuda_matches_cpu(cuda, runtime):
    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.data.partition import partition_clients
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.sim.runtime import make_runtime

    cfg = FLConfig(**RUNTIME_KW, runtime=runtime)
    train, _ = make_image_dataset("mnist", n_train=700, n_test=120, seed=3,
                                  device="cpu")
    clients = partition_clients(train.y, cfg, seed=3)
    params = cnn_adapter("mnist", "cpu").init(rng.PRNGKey(0))
    sel, hist = np.arange(10), np.arange(10) % 3
    got = {}
    for dev in ("cpu", cuda):
        rt = make_runtime(cfg, cnn_adapter("mnist", dev), train.x, train.y,
                          clients, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        if runtime == "device":
            rt.warmup(p)
        agg = rt.train_cohort(p, sel, hist)
        feats = rt.cluster_features(p, rng.PRNGKey(5), "gradient")
        got[str(dev)] = ({k: v.cpu() for k, v in agg.items()}, feats.cpu())
    (p_cpu, f_cpu), (p_gpu, f_gpu) = got["cpu"], got[str(cuda)]
    for k in p_cpu:
        assert float((p_cpu[k] - p_gpu[k]).abs().max()) < 1e-4, k
    assert float((f_cpu - f_gpu).abs().max()) < 1e-4


@pytest.mark.parametrize("scheme,select", [
    ("gradient_cluster_auction", "paper"),
    ("gradient_cluster_random", "paper"), ("random", "paper"),
    ("gradient_cluster_auction", "random"),
    ("gradient_cluster_auction", "fedcs"),
    ("gradient_cluster_auction", "longterm_auction")])
def test_simulate_rounds_on_cuda_has_no_host_sync_and_matches_cpu(
        cuda, scheme, select):
    """The selection-only loop queues its rounds with no host
    synchronisation (``set_sync_debug_mode("error")`` raises on one), is
    bit-identical to its per-round reference on the card, and selects
    the CPU run's winners from the same state."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import rounds as RND
    from repro_torch.core import schemes as SCH

    cfg = FLConfig(num_clients=20_000, num_clusters=10, scheme=scheme,
                   scheme_select=select, init_energy_mode="normal")
    key, kr = rng.PRNGKey(0), rng.fold_in(rng.PRNGKey(0), 1)
    cpu_state = RND.synthetic_fleet(cfg, key, device="cpu")
    state = dataclasses.replace(
        cpu_state, **{f: getattr(cpu_state, f).to(cuda) for f in
                      ("clusters", "residual", "history", "local_sizes")},
        scheme_state=SCH.init_scheme_state(cfg, cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs, m, wins = RND.simulate_rounds(state, cfg, kr, 10,
                                          record_wins=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rf, rm, rwins = RND.simulate_rounds_reference(state, cfg, kr, 10,
                                                  record_wins=True)
    np.testing.assert_array_equal(wins.cpu().numpy(), rwins)
    assert torch.equal(fs.residual, rf.residual)
    assert torch.equal(fs.history, rf.history)
    for k in m:
        np.testing.assert_array_equal(m[k].cpu().numpy(), rm[k], err_msg=k)
    _, _, cwins = RND.simulate_rounds(cpu_state, cfg, kr, 10,
                                      record_wins=True)
    assert torch.equal(wins.cpu(), cwins)


def test_sync_audit_raises_on_item_and_not_on_counted_transfers(cuda):
    from repro_torch import obs
    from repro_torch.obs import torchmon

    x = torch.arange(6.0, device=cuda)
    torch.cuda.synchronize()
    with obs.sync_audit():
        with pytest.raises(RuntimeError):
            x.sum().item()
        with pytest.raises(RuntimeError):
            torch.ones(3).to(cuda)               # blocking pageable copy
        back = obs.device_get((x.sum(), x > 2))
        up = obs.device_put(np.arange(4, dtype=np.float32), cuda)
        assert torchmon.sync_debug_mode() == 2
    assert torchmon.sync_debug_mode() == 0
    assert float(back[0]) == 15.0 and back[1].tolist() == [False] * 3 + \
        [True] * 3
    assert up.device.type == "cuda" and up.tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("profile", ["energy", "uniform", "lognormal",
                                     "none"])
def test_fault_step_and_dynamics_round_step_on_cuda_match_cpu(cuda,
                                                              profile):
    """The fault model and the dynamics round step on the card give the
    CPU's winners, outcome codes, availability and staleness bit for bit;
    latencies within 1e-6 relative (``lognormal``'s exp rounds in the
    last place otherwise on the card)."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import rounds as RND
    from repro_torch.sim import dynamics as DYN

    cfg = FLConfig(num_clients=5_000, num_clusters=10, churn=0.2,
                   deadline=1.1, straggler_profile=profile,
                   init_energy_mode="normal")
    r = np.random.default_rng(1)
    win = torch.tensor(r.uniform(size=5_000) < 0.3)
    avail = torch.tensor(r.uniform(size=5_000) < 0.8)
    residual = torch.tensor(r.uniform(0, 100, 5_000).astype(np.float32))
    sizes = torch.tensor(r.integers(0, 900, 5_000).astype(np.int32))
    key = rng.PRNGKey(3)
    a = DYN.fault_step(cfg, key, win, avail, residual, sizes)
    b = DYN.fault_step(cfg, key, *(t.to(cuda) for t in (win, avail,
                                                        residual, sizes)))
    assert torch.equal(a[0], b[0].cpu()) and torch.equal(a[2], b[2].cpu())
    torch.testing.assert_close(b[1].cpu(), a[1], rtol=1e-6, atol=0.0)

    state = RND.synthetic_fleet(cfg, rng.PRNGKey(0), device="cpu")
    state = dataclasses.replace(
        state, staleness=torch.zeros(5_000, dtype=torch.int32))
    runs = {}
    for dev in ("cpu", cuda):
        s = dataclasses.replace(state, **{
            f: getattr(state, f).to(dev) for f in
            ("clusters", "residual", "history", "local_sizes",
             "staleness")})
        d = DYN.init_dynamics(cfg, dev)
        step = RND.make_round_step(cfg, dynamics=True, device=dev)
        k, dk, rows = rng.PRNGKey(7), DYN.dynamics_key(cfg), []
        for _ in range(5):
            k, sub = rng.split(k)
            dk, dsub = rng.split(dk)
            s, d, w, o, _ = step(s, d, sub, dsub)
            rows.append([t.cpu() for t in (w, o, d.avail, s.staleness,
                                           s.history)])
        runs[str(dev)] = rows
    for x, y in zip(runs["cpu"], runs[str(cuda)]):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


@pytest.mark.parametrize("runtime", ["sequential", "vectorized", "sharded",
                                     "device"])
def test_audited_dynamics_run_on_cuda_matches_cpu(cuda, runtime):
    """A buffered faulty run with its warm rounds under the sync auditor
    on the card selects and classifies as the CPU run, params within
    1e-4."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import partition_clients
    from repro_torch.data.synthetic import make_image_dataset

    cfg = FLConfig(**dict(RUNTIME_KW, rounds=4), runtime=runtime,
                   churn=0.25, deadline=1.2, aggregation="buffered",
                   buffer_goal=1)
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3, device="cpu")
    clients = partition_clients(train.y, cfg, seed=3)
    got = {}
    for dev in ("cpu", cuda):
        srv = FederatedServer(cfg, cnn_adapter("mnist", dev), train.x,
                              train.y, clients,
                              {"x": test.x[:64], "y": test.y[:64]},
                              device=dev)
        logs = srv.run(audit_sync=True, audit_warm_rounds=1)
        got[str(dev)] = ([l.selected.tolist() for l in logs],
                         [o.tolist() for o in srv.outcome_log],
                         {k: v.cpu() for k, v in srv.params.items()})
    (s0, o0, p0), (s1, o1, p1) = got["cpu"], got[str(cuda)]
    assert s0 == s1 and o0 == o1
    for k in p0:
        assert float((p0[k] - p1[k]).abs().max()) < 1e-4, k


@pytest.mark.parametrize("runtime", ["sharded", "device"])
def test_forced_split_on_cuda_matches_cpu(cuda, runtime, monkeypatch):
    """``sharded`` and ``device`` on a cohort mesh that lists the run's
    device 4 times (4 shards), warm rounds under the sync auditor on the
    card: the CPU run's winners, params within 1e-4."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import partition_clients
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.device import canonical_device
    from repro_torch.launch import mesh as MESH

    monkeypatch.setattr(MESH, "make_cohort_mesh",
                        lambda num_devices=0, device="cuda":
                        MESH.CohortMesh((canonical_device(device),) * 4))
    cfg = FLConfig(**dict(RUNTIME_KW, rounds=3), runtime=runtime)
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3, device="cpu")
    clients = partition_clients(train.y, cfg, seed=3)
    got = {}
    for dev in ("cpu", cuda):
        srv = FederatedServer(cfg, cnn_adapter("mnist", dev), train.x,
                              train.y, clients,
                              {"x": test.x[:64], "y": test.y[:64]},
                              device=dev)
        assert srv.runtime.engine.data_axis_size == 4
        logs = srv.run(audit_sync=True, audit_warm_rounds=1)
        got[str(dev)] = ([l.selected.tolist() for l in logs],
                         {k: v.cpu() for k, v in srv.params.items()})
    (s0, p0), (s1, p1) = got["cpu"], got[str(cuda)]
    assert s0 == s1
    for k in p0:
        assert float((p0[k] - p1[k]).abs().max()) < 1e-4, k


# ----------------------------------------------------------------------
# the Byzantine-tolerant path on the card
# ----------------------------------------------------------------------

@pytest.mark.parametrize("watchdog", ["off", "on"])
@pytest.mark.parametrize("mode", ["static", "adaptive"])
@pytest.mark.parametrize("defense", ["none", "clip", "trimmed", "median"])
def test_screened_step_on_cuda_matches_cpu(cuda, defense, mode, watchdog):
    """The screened step at the chip cells' shape (16 rows x 21,840) on
    the card against the same step on the CPU over three chained rounds:
    strikes (the quarantine and band verdicts) and report counts exact,
    ``agg`` within 1e-5, and no host synchronisation inside the step."""
    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import aggregation as AGG

    cfg = FLConfig(num_clients=32, defense=defense, defense_mode=mode,
                   watchdog=watchdog, adversary_frac=0.3, attack="scale",
                   attack_scale=4.0)
    step = AGG.make_screened_step(cfg)
    ds = {"cpu": AGG.init_defense_state(cfg, "cpu"),
          "cuda": AGG.init_defense_state(cfg, cuda)}
    for rnd in range(3):
        g = np.random.default_rng(rnd)
        d = (g.normal(size=(16, 21840))
             * g.uniform(0.5, 1.5, (16, 1))).astype(np.float32)
        valid = np.arange(16) < 12
        d[~valid] = d[0]
        d[3] = np.nan
        w = np.where(valid, g.uniform(0.1, 1.0, 16), 0.0).astype(np.float32)
        w /= w.sum()
        adv = valid & (np.arange(16) % 4 == 1)
        ids = np.where(valid, g.permutation(32)[:16], -1).astype(np.int32)
        strikes = g.uniform(0.0, 1.0, 32).astype(np.float32)
        out = {}
        for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
            args = [torch.tensor(a, device=dev)
                    for a in (d, w, valid, adv, ids, strikes)]
            rnd_t = torch.tensor(rnd, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            with torch.cuda.device(cuda):
                torch.cuda.set_sync_debug_mode(
                    "error" if name == "cuda" else "default")
                try:
                    agg, st, ds[name], rep = step(*args, ds[name], rnd_t,
                                                  rng.PRNGKey(rnd))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            out[name] = (agg.cpu(), st.cpu(),
                         {k: float(v) for k, v in rep.items()})
        (a0, s0, r0), (a1, s1, r1) = out["cpu"], out["cuda"]
        assert torch.equal(s0, s1)
        for k in ("num_quarantined", "num_screened", "num_survivors"):
            assert r0[k] == r1[k], k
        if defense == "none":
            assert torch.isnan(a0).all() and torch.isnan(a1).all()
        else:
            assert float((a0 - a1).abs().max()) < 1e-5


def _robust_run(cuda, runtime, dev, audit, **kw):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import partition_clients
    from repro_torch.data.synthetic import make_image_dataset

    cfg = FLConfig(**dict(RUNTIME_KW, rounds=4), runtime=runtime, **kw)
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3, device="cpu")
    clients = partition_clients(train.y, cfg, seed=3)
    srv = FederatedServer(cfg, cnn_adapter("mnist", dev), train.x, train.y,
                          clients, {"x": test.x[:64], "y": test.y[:64]},
                          device=dev)
    logs = srv.run(audit_sync=audit, audit_warm_rounds=1)
    return ([l.selected.tolist() for l in logs], srv.state.strikes.cpu(),
            dict(srv.defense_totals),
            {k: v.cpu() for k, v in srv.params.items()})


SELFHEAL_KW = dict(adversary_frac=0.3, attack="sub_clip", defense="clip",
                   defense_mode="adaptive", reputation_mode="price",
                   watchdog="on")


def test_defended_runtimes_agree_on_cuda(cuda):
    """The three runtimes' self-healing runs on the card at N = 10 select
    the same clients, strike the same clients and screen the same rows,
    params within 1e-4 of the sequential run's."""
    runs = {rt: _robust_run(cuda, rt, cuda, False, **SELFHEAL_KW)
            for rt in ("sequential", "vectorized", "device")}
    sel, strikes, totals, params = runs["sequential"]
    assert totals["screened"] > 0
    for rt in ("vectorized", "device"):
        s, st, tot, p = runs[rt]
        assert s == sel and torch.equal(st, strikes) and tot == totals, rt
        for k in params:
            assert float((params[k] - p[k]).abs().max()) < 1e-4, (rt, k)


@pytest.mark.parametrize("runtime", ["vectorized", "device"])
def test_defended_warm_loop_has_no_host_sync_and_matches_cpu(cuda, runtime):
    """The defended warm rounds under ``set_sync_debug_mode("error")``
    (``audit_sync``) on the card select and strike as the CPU run."""
    a = _robust_run(cuda, runtime, "cpu", False, **SELFHEAL_KW)
    b = _robust_run(cuda, runtime, cuda, True, **SELFHEAL_KW)
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and a[2] == b[2]
    for k in a[3]:
        assert float((a[3][k] - b[3][k]).abs().max()) < 1e-4, k


# ----------------------------------------------------------------------
# the LM training path: the two hand-written backwards and transformer
# FL on the card against the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,sk", [(True, 0, 300), (True, 37, 300),
                                              (False, 0, 211)])
def test_chunked_attention_backward_on_cuda_matches_cpu(cuda, causal,
                                                        window, sk):
    from repro_torch.models import layers as TL
    g = torch.Generator(device="cpu").manual_seed(sk + window)
    q = torch.randn(2, 300, 3, 64, generator=g)
    k, v = (torch.randn(2, sk, 3, 64, generator=g) for _ in range(2))
    dout = torch.randn(2, 300, 3, 64, generator=g)

    def run(dev):
        ins = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = TL.chunked_attention(*ins, causal=causal, window=window,
                                   q_block=64, kv_block=96)
        grads = torch.autograd.grad(out, ins, dout.to(dev))
        return [t.detach().cpu() for t in (out, *grads)]

    for a, b in zip(run(cuda), run("cpu")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_chunked_xent_backward_on_cuda_matches_cpu(cuda):
    from repro_torch.models import layers as TL
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 300, 64, generator=g)
    w = torch.randn(64, 5000, generator=g) / 8.0
    lab = torch.randint(0, 5000, (2, 300), generator=g)
    mask = (torch.rand(2, 300, generator=g) > 0.2).float()

    def run(dev):
        ins = [t.to(dev).requires_grad_() for t in (x, w)]
        val = TL.chunked_softmax_xent(None, *ins, lab.to(dev), mask.to(dev),
                                      chunk=128)
        return [t.detach().cpu() for t in (val, *torch.autograd.grad(
            val, ins))]

    for a, b in zip(run(cuda), run("cpu")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("runtime", ["sequential", "vectorized", "sharded",
                                     "device"])
def test_transformer_fl_on_cuda_matches_cpu(cuda, runtime):
    """--mode transformer for 2 rounds at 10 clients: the same winners
    and test losses on the card as on the CPU."""
    from repro_torch.launch import train as TRAIN
    args = ["--mode", "transformer", "--clients", "50", "--rounds", "2",
            "--runtime", runtime, "--quiet"]
    got = TRAIN.main(args)
    want = TRAIN.main(args + ["--device", "cpu"])
    assert got["device"] == "cuda" and want["device"] == "cpu"
    assert got["selected"] == want["selected"]
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=1e-5, atol=1e-5)


# the MoE, Mamba and xLSTM blocks on the card against the CPU, at the
# smoke widths, float32: outputs within 1e-4 of the largest (the card
# sums in other orders; TF32 is off), the MoE routing identical
def _block_inputs(arch, kind, seed):
    from repro_torch import rng
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import mamba, moe, xlstm
    cfg = get_smoke_config(arch)
    init = {"moe": moe.init_moe, "mamba": mamba.init_mamba,
            "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}[kind]
    p = init(rng.PRNGKey(seed), cfg, device="cpu")
    g = torch.Generator(device="cpu").manual_seed(seed)
    return cfg, p, torch.randn(2, 37, cfg.d_model, generator=g)


def _close(got, want, rel=1e-4):
    got, want = got.float().cpu(), want.float()
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.parametrize("arch,kind", [
    ("granite-moe-3b-a800m", "moe"), ("jamba-v0.1-52b", "mamba"),
    ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm")])
def test_new_block_on_cuda_matches_cpu(cuda, arch, kind):
    from repro_torch.models import mamba, moe, xlstm
    cfg, p, x = _block_inputs(arch, kind, 3)
    pc = {k: v.to(cuda) for k, v in p.items()}
    if kind == "moe":
        want, aux = moe.apply_moe(p, x, cfg)
        got, aux_c = moe.apply_moe(pc, x.to(cuda), cfg)
        xt = x.reshape(-1, cfg.d_model)
        ids = moe.top_k(moe.router_probs(p, xt), cfg.experts_per_token)[1]
        ids_c = moe.top_k(moe.router_probs(pc, xt.to(cuda)),
                          cfg.experts_per_token)[1]
        assert torch.equal(ids_c.cpu(), ids)
        assert float(aux_c["moe_drop_frac"]) == float(aux["moe_drop_frac"])
    else:
        apply = {"mamba": mamba.apply_mamba, "mlstm": xlstm.apply_mlstm,
                 "slstm": xlstm.apply_slstm}[kind]
        want, got = apply(p, x, cfg), apply(pc, x.to(cuda), cfg)
    assert got.device.type == "cuda"
    _close(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_zoo_decode_on_cuda_matches_cpu(cuda, arch):
    """Teacher-forced decode of the smoke config on both devices."""
    from repro_torch import rng
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as MD
    cfg = get_smoke_config(arch)
    params = MD.init_params(cfg, rng.PRNGKey(0), "cpu")
    pc = MD.nested_params({k: v.to(cuda) for k, v in
                           MD.flatten_params(params).items()})
    toks = rng.randint(rng.PRNGKey(1), (2, 12), 0, cfg.vocab_size, "cpu")
    st = MD.init_decode_state(cfg, 2, 12, "cpu")
    st_c = MD.init_decode_state(cfg, 2, 12, cuda)
    for t in range(12):
        lg, st = MD.decode_step(cfg, params, st, toks[:, t], t)
        lg_c, st_c = MD.decode_step(cfg, pc, st_c, toks[:, t].to(cuda), t)
        _close(lg_c, lg)


def test_whisper_decode_on_cuda_matches_cpu(cuda):
    """The encoder-decoder's smoke config: encode, the cross cache and a
    teacher-forced decode on both devices."""
    from repro_torch import rng
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as MD
    cfg = get_smoke_config("whisper-tiny")
    params = MD.init_params(cfg, rng.PRNGKey(0), "cpu")
    pc = MD.nested_params({k: v.to(cuda) for k, v in
                           MD.flatten_params(params).items()})
    frames = rng.normal(rng.PRNGKey(1), (2, cfg.encoder_seq, cfg.d_model),
                        "cpu")
    toks = rng.randint(rng.PRNGKey(2), (2, 12), 0, cfg.vocab_size, "cpu")
    st = MD.init_decode_state(cfg, 2, 12, "cpu")
    st_c = MD.init_decode_state(cfg, 2, 12, cuda)
    st["cross"] = MD.build_cross_cache(cfg, params,
                                       MD.encode(cfg, params, frames))
    st_c["cross"] = MD.build_cross_cache(cfg, pc, MD.encode(
        cfg, pc, frames.to(cuda)))
    for t in range(12):
        lg, st = MD.decode_step(cfg, params, st, toks[:, t], t)
        lg_c, st_c = MD.decode_step(cfg, pc, st_c, toks[:, t].to(cuda), t)
        _close(lg_c, lg)


@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_normal_draws_on_cuda_equal_the_cpu_bit_for_bit(cuda, n):
    """XLA's log1p and FMAs (xla_math) are elementwise float32 and
    float64 torch ops, each correctly rounded on both devices: a direct
    draw and a table draw give the CPU's bits."""
    from repro_torch import rng
    for fn in (lambda d: rng.normal(rng.PRNGKey(3), (n,), d),
               lambda d: rng.truncated_normal(rng.PRNGKey(3), -2.0, 2.0,
                                              (n,), d)):
        assert torch.equal(fn(cuda).cpu(), fn("cpu"))
