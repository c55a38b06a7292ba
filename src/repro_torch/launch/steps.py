"""Train / serve / FL-round step builders used by the launchers and the
dry run (``repro.launch.steps``).

``train_step`` is one local LM step: loss -> grads -> SGD update, on the
nested model tree.  The optimizer runs over the tree's flat view
(``models.model.flatten_params``), the view the FL plane trains; bf16
params are updated as the JAX package's ``apply_updates`` does,
(p.float() + u).to(p.dtype).

``serve_step`` is one-token greedy decode against the KV cache.

``fl_round_step`` is one federated round over cohorts (the paper's I
local steps per aggregation, eq. 5-8): each cohort's local SGD steps,
then one FedAvg.  On the dry run's multi-pod mesh the cohorts are the
pods, and the FedAvg is the round's one cross-pod collective;
``fl_aggregate`` is the weighted FedAvg.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD
from repro_torch.optim import apply_updates, sgd
from repro_torch.sharding.constrain import (forbid_axes, maybe_constrain,
                                           use_mesh)


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    momentum: float = 0.0, grad_sync=None):
    """(train_step, opt_init): ``train_step(params, opt_state, batch)``
    returns ``(new_params, new_opt_state, loss)``; ``opt_init(params)``
    takes the nested tree.  ``grad_sync(grads, params)`` (both by flat
    key; returns the gradients) runs before the update: the dry run's
    all-reduce over 'pod'."""
    opt_init, opt_update = sgd(lr, momentum=momentum)

    def loss(flat, batch):
        return MD.loss_fn(cfg, MD.nested_params(flat), batch)

    def train_step(params, opt_state, batch):
        flat = MD.flatten_params(params)
        value, grads = MD.value_and_grad(loss, flat, batch)
        if grad_sync is not None:
            grads = grad_sync(grads, flat)
        updates, new_opt = opt_update(grads, opt_state, flat)
        return MD.nested_params(apply_updates(flat, updates)), new_opt, value

    return train_step, lambda params: opt_init(MD.flatten_params(params))


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, pos):
        logits, state = MD.decode_step(cfg, params, state, tokens, pos)
        # in the dry run's mesh the vocab is gathered for the argmax
        # (DTensor has no sharded argmax)
        logits = maybe_constrain(logits, "data", None)
        next_tok = logits.argmax(dim=-1).int()
        return next_tok, state

    return serve_step


# ----------------------------------------------------------------------
# the FL round: cohorts as a leading parameter dim
# ----------------------------------------------------------------------

def _cohort_meshes(t):
    """(the mesh without 'pod', the placements there) of a DTensor whose
    dim 0, the cohort dim, is sharded over 'pod'."""
    mesh = t.device_mesh
    rest = tuple(n for n in mesh.mesh_dim_names if n != "pod")
    pl = []
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if name == "pod":
            continue
        pl.append(type(p)(p.dim - 1) if p.is_shard() else p)
    return mesh[rest], pl


def _local_cohorts(tree: Dict[str, torch.Tensor]) -> List[Dict]:
    """One flat dict per cohort this process holds.  Plain tensors: every
    cohort (row c of the leading dim).  DTensors on a mesh with 'pod':
    the cohorts of this device's pod, each a DTensor on the mesh without
    'pod' (no cross-pod traffic)."""
    from torch.distributed.tensor import DTensor
    first = next(iter(tree.values()))
    if not isinstance(first, DTensor):
        return [{k: v[c] for k, v in tree.items()}
                for c in range(first.shape[0])]
    out = None
    for k, v in tree.items():
        sub, pl = _cohort_meshes(v)
        local = v.to_local()
        shape = v.shape[1:]
        rows = [DTensor.from_local(local[c], sub, pl, run_check=False,
                                   shape=shape,
                                   stride=_contiguous_stride(shape))
                for c in range(local.shape[0])]
        out = out or [{} for _ in rows]
        for c, r in enumerate(rows):
            out[c][k] = r
    return out


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _stack_cohorts(rows: List[Dict], like: Dict[str, torch.Tensor]):
    """Inverse of :func:`_local_cohorts`: the leading cohort dim again,
    placed as ``like``'s leaves."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in like.items():
        parts = [r[k] for r in rows]
        if isinstance(v, DTensor):
            local = torch.stack([p.to_local() for p in parts])
            out[k] = DTensor.from_local(local, v.device_mesh, v.placements,
                                        run_check=False, shape=v.shape,
                                        stride=_contiguous_stride(v.shape))
        else:
            out[k] = torch.stack(parts)
    return out


def _placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` with ``like``'s placements on the mesh: an updated parameter
    keeps its parameter's, whatever its gradient's were."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or t.placements == like.placements:
        return t
    return t.redistribute(like.device_mesh, like.placements)


def _fedavg(t: torch.Tensor) -> torch.Tensor:
    """The float32 mean over the cohort dim, broadcast back to every
    cohort.  With the cohort dim sharded over 'pod' the mean is one
    all-reduce of the device's parameter shard over 'pod'."""
    from torch.distributed.tensor import DTensor, Replicate
    m = t.float().mean(0, keepdim=True)
    if not isinstance(m, DTensor):
        return m.expand(t.shape).to(t.dtype)
    m = m.redistribute(m.device_mesh, [Replicate() if p.is_partial() else p
                                       for p in m.placements])
    m = m.expand(t.shape).redistribute(t.device_mesh, t.placements)
    return m.to(t.dtype)


def _mean_loss(losses: List[torch.Tensor], like: torch.Tensor):
    """The mean of the cohorts' step losses.  On the mesh it comes back
    unreduced over 'pod' (a Partial sum of the pods' shares): the round's
    one cross-pod collective stays the FedAvg, and reading the loss
    reduces it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mean = torch.stack([l.to_local() if isinstance(l, DTensor) else l
                        for l in losses]).mean()
    if not isinstance(like, DTensor):
        return mean
    mesh = like.device_mesh
    pods = mesh.size(mesh.mesh_dim_names.index("pod"))
    return DTensor.from_local(
        mean / pods, mesh, [Partial() if n == "pod" else Replicate()
                            for n in mesh.mesh_dim_names], run_check=False)


def make_fl_round_step(cfg: ModelConfig, lr: float = 1e-3,
                       local_steps: int = 4, n_cohorts: int = 2):
    """One federated round: each cohort runs ``local_steps`` local SGD
    steps, w - lr·g in float32 cast back to the parameter's dtype (the
    paper's I >= 2 local rounds, eq. 5-8), with NO cross-cohort traffic,
    followed by ONE float32 FedAvg of the parameters broadcast to every
    cohort.  Cross-cohort bytes per local step drop ~I x against
    per-step gradient sync.

    ``round_step(params_c, batch_c)`` takes the nested parameter tree
    with a leading cohort dim (n_cohorts, ...) and batch leaves of
    (n_cohorts, local_steps, B / n_cohorts, ...); it returns (params_c
    after the round, the mean loss over cohorts and steps).  Cohorts run
    in a loop, each step through ``models.model.value_and_grad``.  On
    the dry run's multi-pod mesh the cohort dim is sharded over 'pod':
    each device runs its pod's cohort on the mesh without 'pod', and the
    FedAvg is the round's only collective over 'pod'."""

    def loss(flat, batch):
        return MD.loss_fn(cfg, MD.nested_params(flat), batch)

    def cohort_steps(p, batch):
        losses = []
        for s in range(local_steps):
            mb = {k: v[s] for k, v in batch.items()}
            value, g = MD.value_and_grad(loss, p, mb)
            p = {k: _placed_as((w.float() - lr * g[k].float()).to(w.dtype),
                               w) for k, w in p.items()}
            losses.append(value)
        return p, losses

    def round_step(params_c, batch_c):
        flat = MD.flatten_params(params_c)
        cohorts = _local_cohorts(flat)
        batches = _local_cohorts(batch_c)
        first = next(iter(cohorts[0].values()))
        sub = getattr(first, "device_mesh", None)
        rows, losses = [], []
        with forbid_axes("pod"):
            for p, b in zip(cohorts, batches):
                if sub is None:
                    p, ls = cohort_steps(p, b)
                else:
                    with use_mesh(sub):
                        p, ls = cohort_steps(p, b)
                rows.append(p)
                losses += ls
        out = {k: _fedavg(v) for k, v in _stack_cohorts(rows, flat).items()}
        return MD.nested_params(out), _mean_loss(losses,
                                                 next(iter(flat.values())))

    return round_step


def fl_aggregate(params_by_cohort, weights: torch.Tensor):
    """Weighted FedAvg across the cohort axis: w = sum_k p_k w_k, in
    float32, cast back to each leaf's dtype.  ``params_by_cohort``: a
    flat dict or nested tree whose leaves carry the leading cohort dim;
    ``weights``: (n_cohorts,)."""
    w = weights.float() / weights.float().sum()

    def agg(x):
        return torch.tensordot(w, x.float(), dims=1).to(x.dtype)

    if all(isinstance(v, torch.Tensor) for v in params_by_cohort.values()):
        return {k: agg(v) for k, v in params_by_cohort.items()}
    return MD.nested_params({k: agg(v) for k, v in
                             MD.flatten_params(params_by_cohort).items()})
