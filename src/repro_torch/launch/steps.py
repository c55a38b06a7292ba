"""Train / serve step builders (``repro.launch.steps`` without the
multi-pod FL round step, which comes with the dry-run: ROADMAP.md, queue
1, ``launch/dryrun.py``).

``train_step`` is one local LM step: loss -> grads -> SGD update, on the
nested model tree.  The optimizer runs over the tree's flat view
(``models.model.flatten_params``), the view the FL plane trains; bf16
params are updated as the JAX package's ``apply_updates`` does,
(p.float() + u).to(p.dtype).

``serve_step`` is one-token greedy decode against the KV cache.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD
from repro_torch.optim import apply_updates, sgd


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    momentum: float = 0.0):
    """(train_step, opt_init): ``train_step(params, opt_state, batch)``
    returns ``(new_params, new_opt_state, loss)``; ``opt_init(params)``
    takes the nested tree."""
    opt_init, opt_update = sgd(lr, momentum=momentum)

    def loss(flat, batch):
        return MD.loss_fn(cfg, MD.nested_params(flat), batch)

    def train_step(params, opt_state, batch):
        flat = MD.flatten_params(params)
        value, grads = MD.value_and_grad(loss, flat, batch)
        updates, new_opt = opt_update(grads, opt_state, flat)
        return MD.nested_params(apply_updates(flat, updates)), new_opt, value

    return train_step, lambda params: opt_init(MD.flatten_params(params))


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, pos):
        logits, state = MD.decode_step(cfg, params, state, tokens, pos)
        next_tok = logits.argmax(dim=-1).int()
        return next_tok, state

    return serve_step
