"""The CUDA lloyd_step kernel against its plain version on the card.

Marked ``gpu``: it needs a CUDA device and nvcc, and skips elsewhere
(the decision is made inside the fixture, never at import).  Run it on a
GPU machine with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``;
``python3 chip_smoke.py`` makes the same comparison at the fleet shape.
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
    # more 128-row tiles than the grid has blocks: blocks own several
    (70_000, 64, 10, 4, torch.float32)])
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
