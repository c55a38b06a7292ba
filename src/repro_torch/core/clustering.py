"""Gradient-based client clustering (paper §III-C), stage 1 of Algorithm 1:

  1. every client draws ``s_mm`` samples from its local data (the *sample
     window*), repeats ``T0`` times, and averages the gradient of the
     *initial* global model over the draws;
  2. the server k-means-clusters the gradient features into J groups.

The Wang et al. baseline (``weights_cluster_random``) clusters by another
feature: each client's flat model delta after one epoch of local SGD
(``feature_kind="weights"``, with the server's ``local_steps_fn``).

Features wider than ``8 * cluster_feature_dim`` are JL-projected in
column blocks first (the CNN-MNIST gradient has 21,840 entries).  K-means
is k-means++ seeding plus Lloyd's algorithm over ``restarts`` runs that
share one batch axis: every Lloyd iteration of all restarts is ONE call
of the fused step ``repro_torch.kernels.ops.lloyd_step`` (the CUDA kernel
on a GPU).  An ``assign_fn`` hook replaces the assignment (for example
with ``ops.kmeans_assign``, the assign-only CUDA kernel), as the JAX
package's hook does.  The seed implementation is kept as
:func:`kmeans_reference`, the oracle.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops as KOPS


# ----------------------------------------------------------------------
# gradient features
# ----------------------------------------------------------------------

def window_indices(key, local_size: int, window: int,
                   device="cuda") -> torch.Tensor:
    """Sample-window draw: ``window`` indices from [0, local_size) (with
    replacement if the client has fewer samples than the window)."""
    return rng.randint(key, (window,), 0, local_size, device)


def window_index_table(key, sizes: torch.Tensor, resamples: int,
                       window: int) -> torch.Tensor:
    """Every client's sample-window draws at once, (N, resamples, window)
    on ``sizes``' device: entry [i, t] is ``window_indices(fold_in(
    fold_in(key, i), t), sizes[i], window)``, the draws of
    :func:`cluster_clients`' per-client loop, bit for bit."""
    n = sizes.shape[0]
    ki = rng.fold_in_rows(key, torch.arange(n, device=sizes.device))
    kit = rng.fold_in_rows(ki.repeat_interleave(resamples, 0),
                           torch.arange(resamples,
                                        device=sizes.device).repeat(n))
    idx = rng.randint_rows(kit, window, 0,
                           sizes.repeat_interleave(resamples))
    return idx.reshape(n, resamples, window)


def flatten_tree(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the leaves in sorted-key order — ``jax.tree.leaves``'
    order on a dict, not the module's registration order."""
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


def client_gradient_feature(grad_fn: Callable, params, data_x, data_y,
                            local_size: int, cfg: FLConfig, key,
                            flatten: bool = True):
    """Mean gradient of the initial model over T0 sample-window draws."""
    feats = []
    for t in range(cfg.cluster_resamples):
        idx = window_indices(rng.fold_in(key, t), local_size,
                             cfg.sample_window, data_x.device)
        feats.append(grad_fn(params, {"x": data_x[idx], "y": data_y[idx]}))
    mean_g = {k: sum(f[k] for f in feats) / len(feats) for k in feats[0]}
    return flatten_tree(mean_g) if flatten else mean_g


def random_projection(key, in_dim: int, out_dim: int,
                      device="cuda") -> torch.Tensor:
    """Fixed Gaussian (Johnson-Lindenstrauss) projection, the whole
    (in_dim, out_dim) matrix on ``device``: ``normal / sqrt(out_dim)``,
    bit for bit the JAX package's.  The divisor is a float32 tensor on
    the device, so the card divides too (with a host scalar its kernel
    multiplies by the reciprocal).  Fine for tests and small models; the
    fleet-scale path is :func:`project_features_blocked`, which never
    holds more than one column block of it."""
    device = resolve_device(device)
    scale = torch.full((), out_dim, dtype=torch.float32, device=device)
    return rng.normal(key, (in_dim, out_dim), device) / torch.sqrt(scale)


def project_feature(feat: torch.Tensor, proj: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    return feat if proj is None else feat @ proj


def project_features_blocked(key, feats: torch.Tensor, out_dim: int,
                             block: int = 4096) -> torch.Tensor:
    """JL projection of (N, in_dim) features to (N, out_dim) in column
    blocks: block b draws its (block, out_dim) Gaussian slab from
    ``fold_in(key, b)`` and adds ``feats[:, b] @ G_b``, so the whole
    (in_dim, out_dim) matrix is never held.  The slab product is a plain
    float32 matmul."""
    n, in_dim = feats.shape
    nb = -(-in_dim // block)
    fp = torch.nn.functional.pad(feats.float(), (0, nb * block - in_dim))
    acc = torch.zeros((n, out_dim), device=feats.device)
    for b in range(nb):
        g = rng.normal(rng.fold_in(key, b), (block, out_dim), feats.device)
        acc = acc + fp[:, b * block:(b + 1) * block] @ g
    return acc / math.sqrt(out_dim)


# ----------------------------------------------------------------------
# k-means
# ----------------------------------------------------------------------

def assign_ref(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 through the (N, K, F) broadcast."""
    d = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    return d.argmin(dim=1)


def _kmeanspp_init_scan(features, k, key):
    """The seed k-means++: every pick recomputes the distance to *all*
    chosen centroids through an (N, K, F) broadcast (the seeding oracle)."""
    n = features.shape[0]
    k0, key = rng.split(key)
    first = rng.randint(k0, (), 0, n, features.device)
    cent = features[first][None].repeat(k, 1)
    col = torch.arange(k, device=features.device)[None, :]
    for i in range(1, k):
        d = ((features[:, None, :] - cent[None]) ** 2).sum(-1)
        dmin = torch.where(col < i, d, torch.full_like(d, math.inf)).amin(1)
        key, kp = rng.split(key)
        p = dmin / torch.clamp(dmin.sum(), min=1e-30)
        cent = cent.clone()
        cent[i] = features[rng.choice(kp, n, p=p)]
    return cent


def _kmeanspp_init(features, k, key):
    """Incremental k-means++: the running min-distance vector is updated
    with the distance to the newest centroid only; key stream and
    distance math match :func:`_kmeanspp_init_scan` term for term."""
    n = features.shape[0]
    k0, key = rng.split(key)
    first = rng.randint(k0, (), 0, n, features.device)
    c0 = features[first]
    cent = c0[None].repeat(k, 1)
    dmin = ((features - c0[None]) ** 2).sum(-1)
    for i in range(1, k):
        key, kp = rng.split(key)
        p = dmin / torch.clamp(dmin.sum(), min=1e-30)
        cnew = features[rng.choice(kp, n, p=p)]
        cent[i] = cnew
        dmin = torch.minimum(dmin, ((features - cnew[None]) ** 2).sum(-1))
    return cent


def _kmeans_hooked(features, cents, k, iters, assign_fn):
    """Lloyd's algorithm with an external assignment, restart by restart
    (``repro.core.clustering._kmeans_batched`` with ``assign_fn``): labels
    from the hook, a one-hot update, inertia ``((x - cent[lab])^2).sum()``.
    Each centroid's sum adds its rows with ``index_add_``, whose values do
    not depend on the centroid's index, so restarts that reach one
    partition under other cluster numbers tie exactly, as in the JAX
    package."""
    x32 = features.float()
    best = None
    for cent in cents:
        for _ in range(iters):
            lab = assign_fn(features, cent).long()
            counts = torch.bincount(lab, minlength=k).float()[:, None]
            sums = x32.new_zeros(k, x32.shape[1]).index_add_(0, lab, x32)
            cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                               cent).to(features.dtype)
        lab = assign_fn(features, cent).long()
        inertia = float(((x32 - cent[lab].float()) ** 2).sum())
        if best is None or inertia < best[2]:   # first index on ties
            best = (lab.int(), cent, inertia)
    return best[0], best[1]


def kmeans(features: torch.Tensor, k: int, key, iters: int = 25,
           restarts: int = 4, assign_fn: Optional[Callable] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm with k-means++ seeding and best-of-``restarts``
    (by inertia).  features: (N, F).  Returns (labels (N,) int32,
    centroids (k, F)).  Restart r seeds from ``fold_in(key, r)``; all
    restarts advance together, one fused ``lloyd_step`` call per
    iteration plus one for the final assignment (``iters + 1`` calls).
    ``assign_fn(x, c) -> labels`` overrides the assignment: then each
    restart calls it ``iters + 1`` times."""
    cents = torch.stack([_kmeanspp_init(features, k, rng.fold_in(key, r))
                         for r in range(restarts)])         # (R, K, F)
    if assign_fn is not None:
        return _kmeans_hooked(features, cents, k, iters, assign_fn)
    for _ in range(iters):
        _, _, sums, counts = KOPS.lloyd_step(features, cents)
        cnt = counts[..., None]
        cents = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0),
                            cents).to(features.dtype)
    labs, dist, _, _ = KOPS.lloyd_step(features, cents)
    best = int(dist.sum(1).argmin())     # first index on ties, like the oracle
    return labs[best], cents[best]


def kmeans_reference(features: torch.Tensor, k: int, key, iters: int = 25,
                     restarts: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """The seed implementation, the run-for-run oracle: a Python loop over
    restarts with a host sync for each inertia, (N, K, F)-broadcast
    seeding and assignment, and a separate one-hot matmul update.  Same
    per-restart key stream (fold_in) as :func:`kmeans`."""
    def one_run(key):
        cent = _kmeanspp_init_scan(features, k, key)
        for _ in range(iters):
            onehot = torch.nn.functional.one_hot(
                assign_ref(features, cent), k).to(features.dtype)
            counts = onehot.sum(0)[:, None]
            cent = torch.where(counts > 0, (onehot.T @ features)
                               / torch.clamp(counts, min=1.0), cent)
        lab = assign_ref(features, cent)
        return lab, cent, ((features - cent[lab]) ** 2).sum()

    best = None
    for r in range(restarts):
        lab, cent, inertia = one_run(rng.fold_in(key, r))
        if best is None or float(inertia) < best[2]:
            best = (lab, cent, float(inertia))
    return best[0].int(), best[1]


# ----------------------------------------------------------------------
# full clustering stage (Algorithm 1, lines 1-8)
# ----------------------------------------------------------------------

def cluster_clients(grad_fn: Callable, params, client_data, cfg: FLConfig,
                    key, feature_kind: str = "gradient",
                    local_steps_fn: Optional[Callable] = None,
                    assign_fn: Optional[Callable] = None,
                    precomputed_feats: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster all clients.  client_data: list of (x, y) tensors per
    client.  ``feature_kind``:

      * ``'gradient'`` — the paper's scheme (sample window + T0 mean
        gradients);
      * ``'weights'`` — the Wang et al. baseline: the flat local model
        delta after one epoch of SGD, ``local_steps_fn(params, x, y,
        key)``.

    Client i's feature reads ``fold_in(key, i)``.  ``precomputed_feats``
    (N, D) bypasses the per-client feature loop (``client_data`` is then
    unused); ``assign_fn`` overrides k-means' assignment (see
    :func:`kmeans`).  Returns (labels (N,), centroids, features)."""
    if feature_kind not in ("gradient", "weights"):
        raise ValueError(f"unknown feature_kind={feature_kind!r}")
    if precomputed_feats is not None:
        feats = precomputed_feats
    else:
        with obs.span("cluster/features"):
            feats = []
            for i, (x, y) in enumerate(client_data):
                ki = rng.fold_in(key, i)
                feats.append(
                    client_gradient_feature(grad_fn, params, x, y,
                                            x.shape[0], cfg, ki)
                    if feature_kind == "gradient"
                    else local_steps_fn(params, x, y, ki))
            feats = torch.stack(feats)
            synchronize(feats.device)
    if feats.shape[1] > cfg.cluster_feature_dim * 8:
        with obs.span("cluster/project"):
            feats = project_features_blocked(rng.PRNGKey(1234), feats,
                                             cfg.cluster_feature_dim)
            synchronize(feats.device)
    with obs.span("cluster/kmeans"):
        labels, cent = kmeans(feats, cfg.num_clusters, key,
                              assign_fn=assign_fn)
        synchronize(feats.device)
    return labels, cent, feats
