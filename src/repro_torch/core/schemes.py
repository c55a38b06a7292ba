"""Selection-scheme registry for the round control plane.

A :class:`SelectionScheme` is three hooks: ``init_state(cfg)`` (the
carried scheme state, None for stateless schemes), ``select(state, cfg,
key, winners_impl, avail) -> (win, info)`` and ``update_state(...) ->
(new_scheme_state, metrics)``.  The port registers the ``paper`` scheme
(selection.select_round verbatim); the competitors ``random``, ``fedcs``
and ``longterm_auction`` are named here and refused until they are ported
(ROADMAP.md, queue 1: scheme zoo).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import selection as SEL

Metrics = Dict[str, torch.Tensor]

_NOT_PORTED = ("random", "fedcs", "longterm_auction")


@dataclass(frozen=True)
class SelectionScheme:
    name: str
    select: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_state: Callable[[FLConfig], Optional[Any]]
    update_state: Callable[..., Tuple[Optional[Any], Metrics]]
    stateful: bool = False


_REGISTRY: Dict[str, SelectionScheme] = {}


def register(scheme: SelectionScheme) -> SelectionScheme:
    if scheme.name in _REGISTRY:
        raise ValueError(f"scheme {scheme.name!r} already registered")
    _REGISTRY[scheme.name] = scheme
    return scheme


def get_scheme(name: str) -> SelectionScheme:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"selection scheme {name!r} is not ported yet (ROADMAP.md, "
            "queue 1: scheme zoo); only 'paper' runs")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown selection scheme {name!r}; registered "
                       f"schemes: {tuple(sorted(_REGISTRY))}") from None


def init_scheme_state(cfg: FLConfig) -> Optional[Any]:
    return get_scheme(cfg.scheme_select).init_state(cfg)


def _no_state(cfg: FLConfig) -> None:
    return None


def _keep_state(state, new_state, cfg, win, info, client_rewards
                ) -> Tuple[Optional[Any], Metrics]:
    return state.scheme_state, {}


register(SelectionScheme(
    name="paper",
    select=SEL.select_round,
    init_state=_no_state,
    update_state=_keep_state,
))
