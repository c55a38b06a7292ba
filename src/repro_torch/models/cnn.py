"""The paper's three CNN models (§V-A footnotes) in PyTorch.

  * CNN-MNIST : 5x5x10 conv -> 2x2 maxpool -> 5x5x20 conv -> 2x2 maxpool
                -> flatten -> fc 320x50 -> fc 50x10
  * CNN-FMNIST: 5x5x16 conv -> BN -> 2x2 maxpool -> 5x5x32 conv -> BN ->
                2x2 maxpool -> flatten -> fc 1568x10
  * CNN-CIFAR : 5x5x6 conv -> 2x2 maxpool -> 5x5x16 conv -> flatten ->
                fc 400x120 -> fc 120x84 -> fc 84x10

Parameters keep the JAX package's names and layouts (conv weights HWIO,
activations NHWC), so a parameter dict moves between the packages through
numpy unchanged.  The convolution is the same im2col product as the
reference (patches @ w): it runs as a plain float32 matmul, so cuDNN's
TF32 convolution default never touches the numbers.  Dropout is identity
and batch norm uses batch statistics, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import rng
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def _uniform_init(key, shape, fan_in: int, device) -> torch.Tensor:
    std = 1.0 / math.sqrt(fan_in)
    return rng.uniform(key, shape, -std, std, device)


def _pad_same(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Stride-1 "SAME" padding of an NHWC ``x`` as XLA pads it: k - 1
    in all, the odd one at the end."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           padding: str = "VALID") -> torch.Tensor:
    """x: (B, H, W, C); w: (kh, kw, cin, cout) — im2col formulation."""
    kh, kw, cin, cout = w.shape
    if padding == "SAME":
        x = _pad_same(x, kh, kw)
    oh, ow = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    cols = [x[:, i:i + oh, j:j + ow, :]
            for i in range(kh) for j in range(kw)]
    patches = torch.cat(cols, dim=-1)            # (B, oh, ow, kh*kw*cin)
    return patches @ w.reshape(kh * kw * cin, cout) + b


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               padding: str = "VALID") -> torch.Tensor:
    """The library convolution (``F.conv2d`` over NHWC/HWIO through
    permutes): the oracle for :func:`conv2d`'s im2col rewrite, as the
    JAX package's ``conv2d_lax`` is; never called on a path."""
    if padding == "SAME":
        x = _pad_same(x, w.shape[0], w.shape[1])
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1) + b


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool via reshape (VALID semantics)."""
    b, h, w, c = x.shape
    x = x[:, :h - h % 2, :w - w % 2, :]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics, population variance (as ``jnp.var``)."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


_SHAPES = {
    "mnist": (("c1", (5, 5, 1, 10)), ("c2", (5, 5, 10, 20)),
              ("f1", (320, 50)), ("f2", (50, 10))),
    "fmnist": (("c1", (5, 5, 1, 16)), ("bn1", 16), ("c2", (5, 5, 16, 32)),
               ("bn2", 32), ("f1", (1568, 10))),
    "cifar": (("c1", (5, 5, 3, 6)), ("c2", (5, 5, 6, 16)),
              ("f1", (400, 120)), ("f2", (120, 84)), ("f3", (84, 10))),
}


def init_cnn(key, variant: str, device="cuda") -> Params:
    """Same 12-way key split and per-layer keys as the JAX ``init_cnn``:
    the k-th weight layer draws from ``split(key, 12)[k]``."""
    device = resolve_device(device)
    if variant not in _SHAPES:
        raise ValueError(variant)
    ks = rng.split(key, 12)
    params: Params = {}
    layer = 0
    for name, shape in _SHAPES[variant]:
        if name.startswith("bn"):
            params[f"{name}_s"] = torch.ones(shape, device=device)
            params[f"{name}_b"] = torch.zeros(shape, device=device)
            continue
        fan_in = math.prod(shape[:-1])
        params[f"{name}_w"] = _uniform_init(ks[layer], shape, fan_in, device)
        params[f"{name}_b"] = torch.zeros(shape[-1], device=device)
        layer += 1
    return params


def cnn_logits(params: Params, x: torch.Tensor, variant: str
               ) -> torch.Tensor:
    """x: (B, H, W, C) float32 in [0, 1]."""
    p = params
    if variant == "mnist":          # 28x28x1
        h = maxpool2(torch.relu(conv2d(x, p["c1_w"], p["c1_b"])))   # 12
        h = maxpool2(torch.relu(conv2d(h, p["c2_w"], p["c2_b"])))   # 4
        h = h.reshape(h.shape[0], -1)                                 # 320
        h = torch.relu(h @ p["f1_w"] + p["f1_b"])
        return h @ p["f2_w"] + p["f2_b"]
    if variant == "fmnist":         # SAME padding -> 7x7x32 = 1568
        h = torch.relu(conv2d(x, p["c1_w"], p["c1_b"], "SAME"))
        h = maxpool2(batchnorm(h, p["bn1_s"], p["bn1_b"]))           # 14
        h = torch.relu(conv2d(h, p["c2_w"], p["c2_b"], "SAME"))
        h = maxpool2(batchnorm(h, p["bn2_s"], p["bn2_b"]))           # 7
        h = h.reshape(h.shape[0], -1)                                 # 1568
        return h @ p["f1_w"] + p["f1_b"]
    if variant == "cifar":          # 32x32x3
        h = maxpool2(torch.relu(conv2d(x, p["c1_w"], p["c1_b"])))   # 14
        h = maxpool2(torch.relu(conv2d(h, p["c2_w"], p["c2_b"])))   # 5
        h = h.reshape(h.shape[0], -1)                                 # 400
        h = torch.relu(h @ p["f1_w"] + p["f1_b"])
        h = torch.relu(h @ p["f2_w"] + p["f2_b"])
        return h @ p["f3_w"] + p["f3_b"]
    raise ValueError(variant)


def image_shape(variant: str) -> Tuple[int, int, int]:
    return (32, 32, 3) if variant == "cifar" else (28, 28, 1)


def cnn_loss(params: Params, batch: Dict[str, torch.Tensor], variant: str
             ) -> torch.Tensor:
    logp = torch.log_softmax(cnn_logits(params, batch["x"], variant), -1)
    nll = -torch.gather(logp, 1, batch["y"].long()[:, None])[:, 0]
    return nll.mean()


def cnn_accuracy(params: Params, batch: Dict[str, torch.Tensor],
                 variant: str) -> torch.Tensor:
    logits = cnn_logits(params, batch["x"], variant)
    return (logits.argmax(-1) == batch["y"].long()).float().mean()


def cnn_grad(params: Params, batch: Dict[str, torch.Tensor], variant: str
             ) -> Params:
    """d cnn_loss / d params, as a dict with the params' keys."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    loss = cnn_loss(dict(zip(names, leaves)), batch, variant)
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(names, grads))


class CNN(nn.Module):
    """Module view of a parameter dict: ``state_dict`` keys and shapes are
    the JAX package's (``c1_w`` HWIO, ``f1_w`` (in, out), ...)."""

    def __init__(self, variant: str, params: Params):
        super().__init__()
        self.variant = variant
        for name in sorted(params):
            self.register_parameter(name, nn.Parameter(params[name].clone()))

    def params(self) -> Params:
        return {k: v for k, v in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cnn_logits(self.params(), x, self.variant)
