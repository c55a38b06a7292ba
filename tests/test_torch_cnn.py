"""The port's CNNs against repro.models.cnn: logits, loss and every
gradient leaf on parameters carried across through numpy; the interop
round trip; the sorted-key gradient-feature flatten; the optimizer; the
im2col ``conv2d`` against the library oracle ``conv2d_ref``, and that
oracle against the JAX package's ``conv2d_lax`` (both within 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as JCL
from repro.models import cnn as JCNN
from repro.optim import apply_updates as j_apply
from repro.optim import fedprox_grad as j_fedprox
from repro.optim import sgd as j_sgd
from repro_torch import interop, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import clustering as TCL
from repro_torch.models import cnn as TCNN
from repro_torch.optim import apply_updates, fedprox_grad, sgd

# one intra-op thread: pytest-xdist runs several workers on the same
# cores, where torch's spinning OpenMP pools slow every test many-fold
torch.set_num_threads(1)

VARIANTS = ["mnist", "fmnist", "cifar"]


def _batch(variant, n=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n,) + JCNN.image_shape(variant)).astype(np.float32)
    y = r.integers(0, 10, n).astype(np.int32)
    return x, y


def _jax_params(variant, seed=0):
    p = JCNN.init_cnn(jax.random.PRNGKey(seed), variant)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_matches_jax(variant):
    want = _jax_params(variant, seed=4)
    got = TCNN.init_cnn(rng.PRNGKey(4), variant, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_max_ulp(got[k].numpy(), want[k], maxulp=1)


def _outputs_jax(pj, x, y, variant):
    bj = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pj = {k: jnp.asarray(v) for k, v in pj.items()}
    g = JCNN.cnn_grad(pj, bj, variant=variant)
    return (np.asarray(JCNN.cnn_logits(pj, bj["x"], variant)),
            float(JCNN.cnn_loss(pj, bj, variant)),
            {k: np.asarray(v) for k, v in g.items()},
            float(JCNN.cnn_accuracy(pj, bj, variant)))


def _outputs_torch(pj, x, y, variant):
    pt = {k: torch.tensor(v) for k, v in pj.items()}
    bt = {"x": torch.tensor(x), "y": torch.tensor(y)}
    g = TCNN.cnn_grad(pt, bt, variant)
    return (TCNN.cnn_logits(pt, bt["x"], variant).detach().numpy(),
            float(TCNN.cnn_loss(pt, bt, variant)),
            {k: v.numpy() for k, v in g.items()},
            float(TCNN.cnn_accuracy(pt, bt, variant)))


def _assert_outputs_close(got, want, tol):
    """``tol(ref) -> (rtol, atol)`` for each compared array."""
    (lt, st, gt, at), (lj, sj, gj, aj) = got, want
    np.testing.assert_allclose(lt, lj, *tol(lj))
    np.testing.assert_allclose(st, sj, *tol(np.float32(sj)))
    assert sorted(gt) == sorted(gj)
    for k in gj:
        assert gt[k].dtype == gj[k].dtype
        np.testing.assert_allclose(gt[k], gj[k], *tol(gj[k]), err_msg=k)
    assert at == pytest.approx(aj)


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_loss_grad_match_jax(variant):
    """Logits, loss and every gradient leaf at rtol 1e-5, atol 1e-6.

    fmnist is compared in float64 on both sides: its batch norm divides
    by the batch std, and in float32 the reference's batch mean is a
    sequential float32 sum (XLA's CPU reduction) whose rounding, about
    1e-6 relative over 6,272 elements, that division amplifies past the
    bound.  The float32 case has its own test below."""
    pj = _jax_params(variant)
    x, y = _batch(variant)
    if variant == "fmnist":
        pj = {k: v.astype(np.float64) for k, v in pj.items()}
        x = x.astype(np.float64)
        with jax.enable_x64(True):
            want = _outputs_jax(pj, x, y, variant)
    else:
        want = _outputs_jax(pj, x, y, variant)
    _assert_outputs_close(_outputs_torch(pj, x, y, variant), want,
                          lambda ref: (1e-5, 1e-6))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmnist_float32_within_batchnorm_reduction_error(seed):
    """fmnist in float32: every output within 1e-4 of its array's largest
    magnitude (measured: at most 3.5e-5), the size of the reference's
    sequential-sum rounding after batch-norm amplification."""
    pj = _jax_params("fmnist", seed)
    x, y = _batch("fmnist", seed=seed)
    _assert_outputs_close(
        _outputs_torch(pj, x, y, "fmnist"), _outputs_jax(pj, x, y, "fmnist"),
        lambda ref: (0.0, 1e-4 * float(np.abs(ref).max())))


@pytest.mark.parametrize("variant", VARIANTS)
def test_interop_round_trip_exact(variant):
    pj = _jax_params(variant, seed=2)
    back = interop.params_to_numpy(interop.params_from_numpy(pj, "cpu"))
    module = TCNN.CNN(variant, interop.params_from_numpy(pj, "cpu"))
    from_module = interop.params_to_numpy(module.state_dict())
    for k in pj:
        np.testing.assert_array_equal(back[k], pj[k])
        np.testing.assert_array_equal(from_module[k], pj[k])
    x, _ = _batch(variant)
    np.testing.assert_array_equal(
        module(torch.tensor(x)).detach().numpy(),
        TCNN.cnn_logits(interop.params_from_numpy(pj, "cpu"), torch.tensor(x),
                        variant).detach().numpy())


def test_gradient_feature_flatten_order_matches():
    """client_gradient_feature flattens leaves in sorted-key order, the
    order jax.tree.leaves walks a dict (c1_b before c1_w)."""
    cfg = FLConfig(sample_window=6, cluster_resamples=3)
    pj = _jax_params("mnist")
    x, y = _batch("mnist", n=20, seed=1)
    fj = JCL.client_gradient_feature(
        lambda p, b: JCNN.cnn_grad(p, b, variant="mnist"), pj, jnp.asarray(x), jnp.asarray(y), 20, cfg,
        jax.random.PRNGKey(5))
    ft = TCL.client_gradient_feature(
        lambda p, b: TCNN.cnn_grad(p, b, "mnist"),
        interop.params_from_numpy(pj, "cpu"), torch.tensor(x), torch.tensor(y), 20,
        cfg, rng.PRNGKey(5))
    assert ft.shape == (21_840,)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-6)
    # the layer order of the init dict is not the flatten order, and the
    # module registers its parameters in the sorted (flatten) order
    layer_order = list(TCNN.init_cnn(rng.PRNGKey(0), "mnist", "cpu"))
    assert layer_order != sorted(layer_order)
    module = TCNN.CNN("mnist", interop.params_from_numpy(pj, "cpu"))
    assert list(module.state_dict()) == sorted(layer_order)


@pytest.mark.parametrize("momentum,prox", [(0.0, False), (0.9, False),
                                           (0.0, True)])
def test_sgd_steps_match_jax(momentum, prox):
    pj = _jax_params("mnist", seed=1)
    x, y = _batch("mnist", n=16, seed=3)
    bj = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    bt = {"x": torch.tensor(x), "y": torch.tensor(y)}
    ij, uj = j_sgd(0.05, momentum=momentum)
    it, ut = sgd(0.05, momentum=momentum)
    p_j, s_j = pj, ij(pj)
    p_t = interop.params_from_numpy(pj, "cpu")
    g0 = dict(p_t)
    s_t = it(p_t)
    for _ in range(3):
        g_j = JCNN.cnn_grad(p_j, bj, variant="mnist")
        g_t = TCNN.cnn_grad(p_t, bt, "mnist")
        if prox:
            g_j = j_fedprox(g_j, p_j, pj, 0.01)
            g_t = fedprox_grad(g_t, p_t, g0, 0.01)
        u, s_j = uj(g_j, s_j, p_j)
        p_j = j_apply(p_j, u)
        u, s_t = ut(g_t, s_t, p_t)
        p_t = apply_updates(p_t, u)
    for k in pj:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padding,cin,cout", [
    ("VALID", 1, 10), ("VALID", 3, 6), ("SAME", 1, 16), ("SAME", 16, 32),
])
def test_conv2d_im2col_matches_library_oracle(padding, cin, cout):
    """tests/test_sim.py's four cases: the im2col rewrite against
    F.conv2d, and F.conv2d against lax.conv_general_dilated."""
    r = np.random.default_rng(cin * 100 + cout)
    x = r.normal(size=(4, 14, 14, cin)).astype(np.float32)
    w = r.normal(size=(5, 5, cin, cout)).astype(np.float32)
    b = r.normal(size=(cout,)).astype(np.float32)
    xt, wt, bt = torch.tensor(x), torch.tensor(w), torch.tensor(b)
    got = TCNN.conv2d(xt, wt, bt, padding)
    ref = TCNN.conv2d_ref(xt, wt, bt, padding)
    lax_ref = np.asarray(JCNN.conv2d_lax(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), padding))
    assert got.shape == ref.shape == lax_ref.shape
    assert float((got - ref).abs().max()) < 1e-4
    assert float(np.abs(ref.numpy() - lax_ref).max()) < 1e-4
