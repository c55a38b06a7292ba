"""The port's one rule for devices: every function that places tensors
takes a ``device`` that defaults to ``"cuda"``, and asking for cuda with
no GPU present raises.  There is no silent CPU fallback; the CPU runs
only when the caller passes ``device="cpu"`` (``--device cpu``)."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; cuda without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA "
            "device (pass device='cpu', or --device cpu, to run on the CPU)")
    return dev


def canonical_device(device="cuda") -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card (so
    two names of one device compare equal)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU).  The
    stage-1 spans end with it, so their host time holds the device work
    they queued."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
