"""The port's dense JL projection against repro.core.clustering:
``random_projection`` bit for bit with ``jax.random.normal`` through the
port's threefry on both of ``rng.normal``'s routes (the 2^23-value
table at 65,536 elements or more, the direct erfinv below), the
separation check of tests/test_clustering.py, and ``project_feature``
(a float32 matmul, within 1e-5 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import clustering as JCL
from repro_torch import rng
from repro_torch.core import clustering as TCL

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)


@pytest.mark.parametrize("in_dim,out_dim,table", [(2000, 64, True),
                                                  (200, 64, False),
                                                  (300, 48, False)])
def test_random_projection_bit_identical(in_dim, out_dim, table):
    assert (in_dim * out_dim >= rng._TABLE_MIN) == table
    want = np.asarray(JCL.random_projection(jax.random.PRNGKey(0), in_dim,
                                            out_dim))
    got = TCL.random_projection(rng.PRNGKey(0), in_dim, out_dim, "cpu")
    assert got.dtype == torch.float32 and got.shape == (in_dim, out_dim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_projection_preserves_separation():
    r = np.random.default_rng(0)
    a = torch.tensor(r.normal(size=(20, 2000)) + 5, dtype=torch.float32)
    b = torch.tensor(r.normal(size=(20, 2000)) - 5, dtype=torch.float32)
    proj = TCL.random_projection(rng.PRNGKey(0), 2000, 64, "cpu")
    ap, bp = TCL.project_feature(a, proj), TCL.project_feature(b, proj)
    da = float(torch.linalg.norm(ap.mean(0) - bp.mean(0)))
    within = float(ap.std()) + float(bp.std())
    assert da > within          # classes remain separated after projection


def test_project_feature_matches_jax():
    r = np.random.default_rng(1)
    feat = r.normal(size=(5, 200)).astype(np.float32)
    proj = TCL.random_projection(rng.PRNGKey(3), 200, 16, "cpu")
    want = np.asarray(JCL.project_feature(jnp.asarray(feat),
                                          jnp.asarray(proj.numpy())))
    got = TCL.project_feature(torch.tensor(feat), proj).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    f = torch.tensor(feat)
    assert TCL.project_feature(f, None) is f


def test_random_projection_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCL.random_projection(rng.PRNGKey(0), 8, 4)
