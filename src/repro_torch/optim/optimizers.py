"""SGD (+momentum), AdamW and the FedProx proximal-gradient wrapper, as
pure (init, update) pairs over parameter dicts, like the JAX package's.
The state mirrors the parameter dict, so the sharding rules apply to it
unchanged (``sharding/rules.opt_state_specs``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int
    mu: Optional[Tree]       # first moment / momentum, or None
    nu: Optional[Tree] = None    # second moment (AdamW), or None


def _zeros_like_f32(params: Tree) -> Tree:
    return {k: torch.zeros_like(v, dtype=torch.float32)
            for k, v in params.items()}


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
    def init(params: Tree) -> OptState:
        return OptState(0, _zeros_like_f32(params) if momentum else None)

    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        if weight_decay:
            grads = {k: g + weight_decay * params[k].to(g.dtype)
                     for k, g in grads.items()}
        if momentum:
            mu = {k: momentum * state.mu[k] + g.float()
                  for k, g in grads.items()}
            upd = {k: -lr * m for k, m in mu.items()}
        else:
            mu = None
            upd = {k: -lr * g.float() for k, g in grads.items()}
        return upd, OptState(state.step + 1, mu)

    return init, update


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """AdamW with float32 moments and decoupled weight decay on float32
    params.  The bias corrections ``1 - b ** step`` are float32 powers
    on the params' device, as the JAX package's ``step.astype(float32)``
    makes them, not Python doubles."""
    def init(params: Tree) -> OptState:
        return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))

    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        step = state.step + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g.float().square()
              for k, g in grads.items()}
        dev = next(iter(mu.values())).device
        t = torch.full((), step, dtype=torch.float32, device=dev)
        c1 = 1 - torch.full((), b1, dtype=torch.float32, device=dev) ** t
        c2 = 1 - torch.full((), b2, dtype=torch.float32, device=dev) ** t
        upd = {k: -lr * ((m / c1) / (torch.sqrt(nu[k] / c2) + eps)
                         + weight_decay * params[k].float())
               for k, m in mu.items()}
        return upd, OptState(step, mu, nu)

    return init, update


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p.float() + updates[k]).to(p.dtype)
            for k, p in params.items()}


def fedprox_grad(grads: Tree, params: Tree, global_params: Tree,
                 mu: float) -> Tree:
    """FedProx: local objective f_k(w) + mu/2 ||w - w_t||^2 — add
    mu (w - w_t) to the local gradient."""
    return {k: g + mu * (params[k].float()
                         - global_params[k].float()).to(g.dtype)
            for k, g in grads.items()}
