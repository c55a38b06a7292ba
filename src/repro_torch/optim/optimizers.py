"""SGD (+momentum) and the FedProx proximal-gradient wrapper, as pure
(init, update) pairs over parameter dicts, like the JAX package's."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int
    mu: Optional[Tree]       # momentum buffer, or None without momentum


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
    def init(params: Tree) -> OptState:
        mu = ({k: torch.zeros_like(v, dtype=torch.float32)
               for k, v in params.items()} if momentum else None)
        return OptState(0, mu)

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
