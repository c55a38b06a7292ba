"""The port's data pipeline against repro.data: identical labels and
translation shifts, pixels within float rounding, identical partitions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.data import partition as JP
from repro.data import synthetic as JSYN
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.data import partition as TP
from repro_torch.data import synthetic as TSYN

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar"])
def test_image_dataset_matches_jax(name):
    tr_j, te_j = JSYN.make_image_dataset(name, n_train=300, n_test=60,
                                         seed=3)
    tr_t, te_t = TSYN.make_image_dataset(name, n_train=300, n_test=60,
                                         seed=3, device="cpu")
    for a, b in ((tr_j, tr_t), (te_j, te_t)):
        assert b.x.dtype == np.float32 and b.y.dtype == np.int32
        assert b.x.shape == a.x.shape and b.num_classes == a.num_classes
        np.testing.assert_array_equal(b.y, a.y)
        # pixels: the normal draws agree to a few ulps and the bilinear
        # upsampling to float rounding
        np.testing.assert_allclose(b.x, a.x, rtol=0, atol=1e-6)


def test_templates_border_rows_match_jax():
    """jax.image.resize renormalises its kernel weights at the borders
    where F.interpolate clamps the source index; when upsampling 7 -> 28
    the two give the same weights, border rows and columns included."""
    want = np.asarray(JSYN._templates(jax.random.PRNGKey(2), 10,
                                      (28, 28, 1)))
    got = TSYN._templates(rng.PRNGKey(2), 10, (28, 28, 1), "cpu").numpy()
    for edge in (slice(0, 2), slice(-2, None)):
        np.testing.assert_allclose(got[:, edge], want[:, edge], atol=1e-6)
        np.testing.assert_allclose(got[:, :, edge], want[:, :, edge],
                                   atol=1e-6)


def test_per_sample_roll_matches_jnp_roll():
    g = np.random.default_rng(0)
    base = g.standard_normal((6, 5, 7, 2)).astype(np.float32)
    sh = g.integers(-2, 3, (6, 2))
    got = TSYN._roll(torch.tensor(base), torch.tensor(sh)).numpy()
    for n in range(6):
        want = np.asarray(jnp.roll(jnp.roll(base[n], int(sh[n, 0]), axis=0),
                                   int(sh[n, 1]), axis=1))
        np.testing.assert_array_equal(got[n], want)


@pytest.mark.parametrize("nu", [1.0, 0.5])
def test_partition_identical(nu):
    tr, _ = JSYN.make_image_dataset("mnist", n_train=1200, n_test=10, seed=0)
    kw = dict(num_clients=12, non_iid_level=nu)
    cj = JP.partition_clients(tr.y, JConfig(**kw), seed=5)
    ct = TP.partition_clients(tr.y, FLConfig(**kw), seed=5)
    assert len(cj) == len(ct)
    for a, b in zip(cj, ct):
        for f in ("train_idx", "val_idx", "test_idx"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.primary_label == a.primary_label
    np.testing.assert_array_equal(TP.global_histogram(tr.y, 10),
                                  JP.global_histogram(tr.y, 10))
