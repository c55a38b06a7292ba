"""Moving parameters and selection state between the JAX package and the
port through numpy.  Names, layouts and dtypes are the JAX package's: a
CNN parameter dict keeps ``c1_w`` (HWIO), ``f1_w`` (in, out), ... and
every float is float32 (JAX runs with x64 off).  A transformer's tree
keeps its nesting: ``tok_embed``, ``blocks`` (a tuple with one dict per
cycle position, each leaf with a leading group axis), ``final_norm`` and
an optional ``lm_head``, in the config's dtype; the FL plane holds it in
its flat view (``models.model.flatten_params``)."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.selection import SelectionState
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import flatten_params, nested_params


def params_from_numpy(tree: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameters (as numpy arrays) -> the port's parameter dict."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The port's parameter dict (or a module's ``state_dict``) -> numpy."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def selection_state_from_numpy(clusters, residual, history, local_sizes,
                               device="cuda") -> SelectionState:
    """Cluster ids, residual energy, participation history and local
    sizes (numpy, as the JAX SelectionState holds them) -> the port's
    SelectionState."""
    device = resolve_device(device)

    def as_t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return SelectionState(clusters=as_t(clusters, torch.int32),
                          residual=as_t(residual, torch.float32),
                          history=as_t(history, torch.int32),
                          local_sizes=as_t(local_sizes, torch.int32))


def model_params_from_numpy(tree: Any, cfg, device="cuda") -> Any:
    """A JAX transformer parameter tree (numpy leaves) -> the port's tree,
    name for name, in ``cfg.dtype``.  A JAX bfloat16 array reaches numpy
    as ``ml_dtypes.bfloat16``; it goes through float32, which holds every
    bfloat16 value exactly."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return torch.tensor(np.asarray(node, np.float32),
                            device=device).to(dt)

    return conv(tree)


def model_params_to_numpy(tree: Any) -> Any:
    """The port's transformer parameter tree -> numpy float32 leaves, with
    the same nesting (tuples stay tuples)."""
    if isinstance(tree, Mapping):
        return {k: model_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(model_params_to_numpy(v) for v in tree)
    return tree.detach().float().cpu().numpy()


def flat_params_from_numpy(tree: Any, cfg, device="cuda"
                           ) -> Dict[str, torch.Tensor]:
    """A JAX transformer parameter tree (numpy leaves) -> the flat view
    the port's ``transformer_adapter`` trains."""
    return flatten_params(model_params_from_numpy(tree, cfg, device))


def flat_params_to_numpy(flat: Mapping[str, torch.Tensor]) -> Any:
    """The adapter's flat view -> the JAX package's tree with numpy
    float32 leaves (``jax.tree.map(np.asarray, ...)``'s nesting)."""
    return model_params_to_numpy(nested_params(dict(flat)))
