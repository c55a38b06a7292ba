"""The fused Lloyd step's plain versions and the port's k-means against
the JAX package: repro.kernels.ref, the interpret-mode Pallas kernel, the
jnp twin (ops.lloyd_step impl="auto" off TPU) and repro.core.clustering.  The CUDA kernel itself runs only on a GPU (see
tests/test_torch_gpu.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as JCL
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.kmeans import lloyd_step as pallas_lloyd_step
from repro_torch import rng
from repro_torch.core import clustering as TCL
from repro_torch.kernels import kmeans as TKM
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

SWEEP = [(256, 128, 8), (16, 8, 2), (100, 64, 10), (257, 256, 7),
         (130, 100, 16), (33, 33, 3)]
PLAIN = {"ref": TREF.lloyd_step_ref, "twin": TOPS._lloyd_step_torch}


def _xc(n, f, k, seed=0, r=None):
    g = np.random.default_rng(n * f + k + seed)
    x = g.standard_normal((n, f)).astype(np.float32)
    shape = (k, f) if r is None else (r, k, f)
    return x, g.standard_normal(shape).astype(np.float32)


def _assert_step_equal(got, want, n):
    lab, dist, sums, counts = (np.asarray(a) for a in got)
    lab_w, dist_w, sums_w, counts_w = (np.asarray(a) for a in want)
    assert lab.dtype == np.int32 and dist.dtype == np.float32
    np.testing.assert_array_equal(lab, lab_w)
    np.testing.assert_allclose(dist, dist_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sums, sums_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts, counts_w)
    assert int(counts.sum()) == n


@pytest.mark.parametrize("n,f,k", SWEEP)
@pytest.mark.parametrize("plain", sorted(PLAIN))
def test_plain_lloyd_step_matches_jax(n, f, k, plain):
    x, c = _xc(n, f, k)
    got = [t.numpy() for t in PLAIN[plain](torch.tensor(x),
                                           torch.tensor(c))]
    _assert_step_equal(got, JREF.lloyd_step_ref(jnp.asarray(x),
                                                jnp.asarray(c)), n)
    _assert_step_equal(got, pallas_lloyd_step(jnp.asarray(x), jnp.asarray(c),
                                              interpret=True), n)
    _assert_step_equal(got, JOPS.lloyd_step(jnp.asarray(x), jnp.asarray(c),
                                            impl="auto"), n)


@pytest.mark.parametrize("plain", sorted(PLAIN))
def test_restart_batch_equals_single_calls(plain):
    x, c = _xc(150, 40, 6, r=4)
    xt, ct = torch.tensor(x), torch.tensor(c)
    batched = PLAIN[plain](xt, ct)
    assert [tuple(t.shape) for t in batched] == [(4, 150), (4, 150),
                                                 (4, 6, 40), (4, 6)]
    for r in range(4):
        single = PLAIN[plain](xt, ct[r])
        for b, s in zip(batched, single):
            np.testing.assert_array_equal(b[r].numpy(), s.numpy())


def test_ops_dispatch_on_cpu_uses_plain_version_and_never_launches():
    x, c = _xc(100, 256, 10, r=4)
    before = TOPS.lloyd_step.launches
    got = TOPS.lloyd_step(torch.tensor(x), torch.tensor(c))
    want = TOPS._lloyd_step_torch(torch.tensor(x), torch.tensor(c))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert TOPS.lloyd_step.launches == before == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    x, c = _xc(16, 8, 2, r=1)
    with pytest.raises(ValueError, match="CUDA"):
        TKM.lloyd_step_cuda(torch.tensor(x), torch.tensor(c))


def _blobs(seed, n=100, f=256, k=10):
    g = np.random.default_rng(seed)
    centers = g.standard_normal((k, f)) * 3
    x = centers[g.integers(0, k, n)] + g.standard_normal((n, f))
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeanspp_picks_match_jax(seed):
    feats = _blobs(seed)
    for init_t, init_j in ((TCL._kmeanspp_init, JCL._kmeanspp_init),
                           (TCL._kmeanspp_init_scan,
                            JCL._kmeanspp_init_scan)):
        want = np.asarray(init_j(jnp.asarray(feats), 10,
                                 jax.random.PRNGKey(seed)))
        got = init_t(torch.tensor(feats), 10, rng.PRNGKey(seed)).numpy()
        np.testing.assert_array_equal(got, want)   # the same rows picked


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_labels_match_jax(seed):
    feats = _blobs(seed + 10)
    lab_j, cent_j = JCL.kmeans(jnp.asarray(feats), 10,
                               jax.random.PRNGKey(seed))
    lab_t, cent_t = TCL.kmeans(torch.tensor(feats), 10, rng.PRNGKey(seed))
    assert lab_t.dtype == torch.int32
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(cent_t.numpy(), np.asarray(cent_j),
                               rtol=1e-4, atol=1e-4)
    lab_r, _ = TCL.kmeans_reference(torch.tensor(feats), 10,
                                    rng.PRNGKey(seed))
    lab_jr, _ = JCL.kmeans_reference(jnp.asarray(feats), 10,
                                     jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(lab_r.numpy(), np.asarray(lab_jr))
    np.testing.assert_array_equal(lab_r.numpy(), lab_t.numpy())


def test_blocked_projection_matches_jax():
    """21,840 features -> 6 slabs of (4096, 256) Gaussians keyed by
    fold_in(PRNGKey(1234), b), as at the CNN-MNIST width."""
    feats = np.random.default_rng(0).standard_normal(
        (12, 21_840)).astype(np.float32) * 1e-2
    want = np.asarray(JCL.project_features_blocked(
        jax.random.PRNGKey(1234), jnp.asarray(feats), 256))
    got = TCL.project_features_blocked(rng.PRNGKey(1234),
                                       torch.tensor(feats), 256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
