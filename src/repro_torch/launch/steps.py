"""Serve step builder (the serving half of ``repro.launch.steps``).

``serve_step`` is one-token greedy decode against the KV cache.  The
train-step builders come with transformer training (ROADMAP.md, queue 1
step 15).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, pos):
        logits, state = MD.decode_step(cfg, params, state, tokens, pos)
        next_tok = logits.argmax(dim=-1).int()
        return next_tok, state

    return serve_step
