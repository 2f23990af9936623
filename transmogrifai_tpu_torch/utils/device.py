"""Device resolution for the stages that run torch computations.

The workflow and its device stages default to ``"cuda"``.  A CUDA device
that is asked for and is not there is an error: nothing here moves the
work to the CPU quietly.  The CPU is used only when the caller names it.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) -> ``torch.device``;
    raises ``RuntimeError`` when it names CUDA and CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
