"""Moving parameters and selection state between the JAX package and the
port through numpy.  Names, layouts and dtypes are the JAX package's: a
CNN parameter dict keeps ``c1_w`` (HWIO), ``f1_w`` (in, out), ... and
every float is float32 (JAX runs with x64 off)."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.selection import SelectionState
from repro_torch.device import resolve_device


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
