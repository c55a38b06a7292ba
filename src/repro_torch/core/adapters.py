"""Model adapters: the FL server is model-agnostic; an adapter binds a
trainable model (the paper's CNNs, or a registry transformer) to the
(init, loss, grad, accuracy) interface the federated loop needs.
Parameters are flat dicts of tensors (a transformer's tree in
``models.model.flatten_params``' view, whose sorted keys follow
``jax.tree.leaves``); gradients come from ``torch.autograd``."""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import cnn as CNN
from repro_torch.models import model as MD


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


def transformer_adapter(cfg, device="cuda") -> ModelAdapter:
    """FL over a registry architecture: batches carry token sequences; the
    'label' used for non-IID partitioning is the topic id (data
    pipeline).

    Batch format: {"x": tokens (B, S), "y": topic (unused by the loss)}.
    The LM objective is next-token prediction over x: tokens x[:, :-1],
    labels x[:, 1:], every position counted.  Params are the flat view of
    the model tree; ``loss`` and ``accuracy`` rebuild the nested view
    (the same tensors) for ``loss_fn`` and ``logits_fn``.  The batches
    carry no encoder frames, so an encoder-decoder config fails in its
    forward pass, as in the JAX package."""
    device = resolve_device(device)

    def loss(params, batch):
        toks = batch["x"]
        lm_batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": torch.ones(toks[:, 1:].shape, device=toks.device),
        }
        return MD.loss_fn(cfg, MD.nested_params(params), lm_batch)

    def accuracy(params, batch):
        toks = batch["x"]
        logits = MD.logits_fn(cfg, MD.nested_params(params), toks[:, :-1])
        return (logits.argmax(-1) == toks[:, 1:].long()).float().mean()

    return ModelAdapter(
        init=lambda key: MD.flatten_params(MD.init_params(cfg, key, device)),
        loss=loss,
        grad=lambda params, batch: MD.value_and_grad(loss, params,
                                                     batch)[1],
        accuracy=accuracy,
    )
