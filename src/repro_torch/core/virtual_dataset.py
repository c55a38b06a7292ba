"""Federated virtual dataset (paper §III-B): the union of the round's
selected local datasets.  The round metric is the total-variation gap
between its label distribution and the global one.

The host helpers (:func:`label_histogram` through
:func:`virtual_dataset_size`) measure it from the clients' label arrays,
as the JAX package's do: they are the oracle the round's device metric,
:func:`virtual_dataset_gap_device`, is held to, and a reporting helper,
never on the round path.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def label_histogram(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Normalised float32 label histogram on ``labels``' device."""
    h = torch.bincount(labels.reshape(-1).long(),
                       minlength=num_classes)[:num_classes].float()
    return h / torch.clamp(h.sum(), min=1.0)


def virtual_dataset_histogram(client_labels: Sequence[np.ndarray],
                              selected: np.ndarray, num_classes: int,
                              device="cuda") -> torch.Tensor:
    """Label distribution of xi_t = U_{k in selected} xi_k on ``device``;
    the uniform histogram when nobody is selected."""
    device = resolve_device(device)
    parts = [client_labels[i] for i in np.nonzero(np.asarray(selected))[0]]
    if not parts:
        return torch.full((num_classes,), 1.0 / num_classes, device=device)
    labels = np.concatenate([np.asarray(p) for p in parts])
    return label_histogram(torch.as_tensor(labels, device=device),
                           num_classes)


def virtual_dataset_gap(client_labels: Sequence[np.ndarray],
                        selected: np.ndarray, global_hist,
                        num_classes: int, device="cuda") -> float:
    """TV(xi_t distribution, global distribution) — smaller means the
    round's virtual dataset better matches the global data (the paper's
    goal)."""
    h = virtual_dataset_histogram(client_labels, selected, num_classes,
                                  device)
    g = torch.as_tensor(np.asarray(global_hist), dtype=torch.float32,
                        device=h.device)
    return float(tv_distance(h, g))


def virtual_dataset_size(client_sizes: np.ndarray,
                         selected: np.ndarray) -> int:
    """|xi_t|: the selected clients' samples in all."""
    return int((client_sizes * selected).sum())


def client_count_histograms(client_labels: Sequence[np.ndarray],
                            num_classes: int) -> np.ndarray:
    """(N, num_classes) per-client label *counts* (not normalized),
    precomputed once on the host."""
    h = np.zeros((len(client_labels), num_classes), np.float32)
    for i, lab in enumerate(client_labels):
        np.add.at(h[i], np.asarray(lab), 1.0)
    return h


def tv_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Total-variation distance between two label distributions."""
    return 0.5 * (p - q).abs().sum()


def virtual_dataset_gap_device(selected: torch.Tensor,
                               count_hists: torch.Tensor,
                               global_hist: torch.Tensor) -> torch.Tensor:
    """TV(xi_t label distribution, global distribution): xi_t's histogram
    is the winner-masked sum of the per-client counts; an empty round
    falls back to the uniform histogram."""
    h = selected.float() @ count_hists                       # (C,)
    num_classes = count_hists.shape[1]
    hist = torch.where(selected.any(), h / torch.clamp(h.sum(), min=1.0),
                       torch.full_like(h, 1.0 / num_classes))
    return tv_distance(hist, global_hist)
