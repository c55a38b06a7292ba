"""The k-means kernels' plain versions (the fused Lloyd step and the
assign-only step) and the port's k-means against the JAX package:
repro.kernels.ref, the interpret-mode Pallas kernels, the jnp twin
(ops.lloyd_step impl="auto" off TPU) and repro.core.clustering, with and
without the ``assign_fn`` hook.  The CUDA kernels themselves run only on
a GPU (see tests/test_torch_gpu.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as JCL
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.kmeans import kmeans_assign as pallas_kmeans_assign
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


@pytest.mark.parametrize("n", [100, 1000])
def test_plain_step_keeps_permuted_restarts_bit_identical(n):
    """The CPU twin of the gpu test of the same name: restart 1 holds
    restart 0's centroids under permuted ids, and the plain step gives it
    the same distances, sums and counts to the bit."""
    x, c0 = _xc(n, 256, 10, seed=5)
    perm = np.random.default_rng(n).permutation(10)
    inv_perm = np.argsort(perm)
    c = torch.tensor(np.stack([c0, c0[perm]]))          # c[1] = c[0][perm]
    lab, dist, sums, counts = (t.numpy() for t in
                               TOPS._lloyd_step_torch(torch.tensor(x), c))
    np.testing.assert_array_equal(lab[1], inv_perm[lab[0]])
    np.testing.assert_array_equal(dist[1], dist[0])
    np.testing.assert_array_equal(sums[1], sums[0][perm])
    np.testing.assert_array_equal(counts[1], counts[0][perm])


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


@pytest.mark.parametrize("n,f,k", [
    (16, 8, 2), (100, 64, 10), (257, 256, 7), (512, 100, 16), (33, 33, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kmeans_assign_matches_jax(n, f, k, dtype):
    """fp32: labels exactly and distances at 1e-4.  bf16: both packages
    read the same bf16 values, so the distances agree at 1e-4 too, but a
    near-tie may flip, so the port's label is held to be nearest by
    distance instead of equal (as tests/test_kernels.py does)."""
    x, c = _xc(n, f, k, seed=7)
    jx, jc = jnp.asarray(x, dtype), jnp.asarray(c, dtype)
    lab_j, dist_j = pallas_kmeans_assign(jx, jc, interpret=True)
    tx, tc = (torch.tensor(a).to(getattr(torch, dtype)) for a in (x, c))
    lab, dist = TOPS._kmeans_assign_torch(tx, tc)
    assert lab.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dist.numpy(),
                               np.asarray(JREF.kmeans_min_dist_ref(jx, jc)),
                               rtol=1e-4, atol=1e-4)
    if dtype == "float32":
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
        np.testing.assert_array_equal(lab.numpy(),
                                      np.asarray(JREF.kmeans_assign_ref(jx,
                                                                        jc)))
        np.testing.assert_array_equal(TREF.kmeans_assign_ref(tx, tc).numpy(),
                                      lab.numpy())
    d = ((tx.double()[:, None] - tc.double()[None]) ** 2).sum(-1)
    picked = d.gather(1, lab.long()[:, None])[:, 0]
    assert bool((picked - d.amin(1) <= 1e-4 * d.amin(1) + 1e-4).all())


def test_ops_kmeans_assign_on_cpu_uses_plain_version_and_never_launches():
    x, c = _xc(100, 256, 10)
    got = TOPS.kmeans_assign(torch.tensor(x), torch.tensor(c))
    want = TOPS._kmeans_assign_torch(torch.tensor(x), torch.tensor(c))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert TOPS.kmeans_assign.launches == 0


def test_assign_cuda_wrapper_refuses_cpu_tensors():
    x, c = _xc(16, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TKM.kmeans_assign_cuda(torch.tensor(x), torch.tensor(c))


def test_kmeans_with_assign_hook_matches_jax():
    """tests/test_kernels.py's four blobs through the assign hook: the
    port's kmeans with ops.kmeans_assign gives the JAX package's labels
    with its interpret-mode Pallas kernel."""
    g = np.random.default_rng(0)
    centers = g.normal(size=(4, 16)) * 10
    pts = np.concatenate([c + g.normal(size=(50, 16))
                          for c in centers]).astype(np.float32)
    lab_j, cent_j = JCL.kmeans(
        jnp.asarray(pts), 4, jax.random.PRNGKey(0),
        assign_fn=lambda x, c: pallas_kmeans_assign(x, c, interpret=True)[0])
    lab_t, cent_t = TCL.kmeans(
        torch.tensor(pts), 4, rng.PRNGKey(0),
        assign_fn=lambda x, c: TOPS.kmeans_assign(x, c)[0])
    assert lab_t.dtype == torch.int32
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(cent_t.numpy(), np.asarray(cent_j),
                               rtol=1e-4, atol=1e-4)
    lab = lab_t.numpy().reshape(4, 50)
    assert all(len(np.unique(row)) == 1 for row in lab)
    assert len(np.unique(lab[:, 0])) == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_hook_keeps_the_fused_paths_labels(seed):
    """At stage 1's shape the hooked k-means reaches the partition of the
    fused Lloyd path, restart ties included."""
    feats = torch.tensor(_blobs(seed + 20))
    lab_f, _ = TCL.kmeans(feats, 10, rng.PRNGKey(seed))
    lab_h, _ = TCL.kmeans(feats, 10, rng.PRNGKey(seed),
                          assign_fn=lambda x, c: TOPS.kmeans_assign(x, c)[0])
    np.testing.assert_array_equal(lab_h.numpy(), lab_f.numpy())


def test_federated_server_takes_the_assign_hook():
    """FederatedServer(assign_fn=...) clusters through the hook, with the
    JAX server's clusters under its own hook (tests/test_sim.py's size)."""
    from repro.configs.base import FLConfig as JConfig
    from repro.core.adapters import cnn_adapter as j_adapter
    from repro.core.server import FederatedServer as JServer
    from repro.data.partition import partition_clients
    from repro.data.synthetic import make_image_dataset
    from repro_torch import interop
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter as t_adapter
    from repro_torch.core.server import FederatedServer as TServer

    kw = dict(num_clients=10, num_clusters=3, select_ratio=0.4, rounds=1,
              sample_window=10, cluster_resamples=2,
              init_energy_mode="normal", seed=3)
    train, test = make_image_dataset("mnist", n_train=700, n_test=120,
                                     seed=3)
    clients = partition_clients(train.y, JConfig(**kw), seed=3)
    tb = {"x": test.x[:64], "y": test.y[:64]}
    calls = []

    def hook(x, c):
        calls.append(tuple(c.shape))
        return TOPS.kmeans_assign(x, c)[0]

    js = JServer(JConfig(**kw), j_adapter("mnist"), train.x, train.y,
                 clients, tb, assign_fn=lambda x, c: pallas_kmeans_assign(
                     x, c, interpret=True)[0])
    ts = TServer(FLConfig(**kw), t_adapter("mnist", "cpu"), train.x, train.y,
                 clients, tb, assign_fn=hook, device="cpu")
    ts.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}, "cpu")
    js.cluster()
    ts.cluster()
    assert calls == [(3, 256)] * (26 * 4)      # 25 iterations + 1, 4 restarts
    np.testing.assert_array_equal(ts.state.clusters.numpy(),
                                  np.asarray(js.state.clusters))
