"""Federated virtual dataset (paper §III-B): the union of the round's
selected local datasets.  The round metric is the total-variation gap
between its label distribution and the global one."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def client_count_histograms(client_labels: Sequence[np.ndarray],
                            num_classes: int) -> np.ndarray:
    """(N, num_classes) per-client label *counts* (not normalized),
    precomputed once on the host."""
    h = np.zeros((len(client_labels), num_classes), np.float32)
    for i, lab in enumerate(client_labels):
        np.add.at(h[i], np.asarray(lab), 1.0)
    return h


def tv_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
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
