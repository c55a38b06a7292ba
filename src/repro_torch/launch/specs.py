"""Shape stand-ins for every model input (``repro.launch.specs``): tensors
on the meta device, which carry a shape and a dtype and hold no memory.
The dry run (``launch.dryrun``) places them on the production mesh.

:func:`params_shape` and :func:`decode_state_shape` run the port's own
``init_params`` and ``init_decode_state`` on the meta device, so the
shapes are the model code's; the random draws hand back empty meta
tensors there (``rng._from_bits``), so even qwen3-moe-235b-a22b's
parameters take well under a second and no byte.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as MD
from repro_torch.models.layers import torch_dtype

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a torch dtype or a
    config's dtype name): ``jax.ShapeDtypeStruct``'s counterpart."""
    return torch.empty(shape, dtype=torch_dtype(dtype), device=META)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Inputs of train_step: the token batch (+ stub modality embeddings)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((B, S), torch.int32),
        "labels": sds((B, S), torch.int32),
        "mask": sds((B, S), torch.float32),
    }
    if cfg.num_prefix_tokens:  # vlm: projected patch embeddings (stub)
        batch["prefix_embeddings"] = sds(
            (B, cfg.num_prefix_tokens, cfg.d_model), cfg.dtype)
    if cfg.is_encdec:          # audio: conv/mel frame embeddings (stub)
        batch["encoder_frames"] = sds(
            (B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Inputs of serve_step: one token per sequence + current position."""
    B = shape.global_batch
    return {
        "tokens": sds((B,), torch.int32),
        "pos": sds((), torch.int32),
    }


def params_shape(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors."""
    return MD.init_params(cfg, rng.PRNGKey(0), device=META)


def decode_state_shape(cfg: ModelConfig, shape: ShapeConfig):
    """The decode state tree of ``cfg`` at ``shape`` as meta tensors."""
    return MD.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device=META)
