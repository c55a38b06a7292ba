"""Model adapters: the FL server is model-agnostic; an adapter binds a
trainable model to the (init, loss, grad, accuracy) interface the
federated loop needs.  Parameters are dicts of tensors; gradients come
from ``torch.autograd``."""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict

import torch

from repro_torch.models import cnn as CNN
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ModelAdapter:
    init: Callable[[Any], Any]                      # key -> params
    loss: Callable[[Any, Dict], torch.Tensor]       # (params, batch) -> ()
    grad: Callable[[Any, Dict], Any]                # (params, batch) -> grads
    accuracy: Callable[[Any, Dict], torch.Tensor]
    batch_fields: tuple = ("x", "y")


def cnn_adapter(variant: str, device="cuda") -> ModelAdapter:
    device = resolve_device(device)
    return ModelAdapter(
        init=lambda key: CNN.init_cnn(key, variant, device),
        loss=partial(CNN.cnn_loss, variant=variant),
        grad=partial(CNN.cnn_grad, variant=variant),
        accuracy=partial(CNN.cnn_accuracy, variant=variant),
    )
