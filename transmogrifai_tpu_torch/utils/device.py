"""Device resolution for the stages that run torch computations.

The workflow and its device stages default to ``"cuda"``.  A CUDA device
that is asked for and is not there is an error: nothing here moves the
work to the CPU quietly.  The CPU is used only when the caller names it.
In a process group that ``parallel.distributed.initialize`` brought up,
``"cuda"`` means the rank's own card (``cuda:{LOCAL_RANK}``), in every
thread of the process.
"""
from __future__ import annotations

from typing import Optional

import torch

#: the card this process's rank drives, once a process group is up
_rank_device: Optional[int] = None


def set_rank_device(index: Optional[int]) -> None:
    """Make ``"cuda"`` mean ``cuda:{index}`` in this process and make it
    torch's current device; ``None`` forgets it.  Called by
    ``parallel.distributed.initialize`` and ``shutdown``."""
    global _rank_device
    _rank_device = index
    if index is not None:
        torch.cuda.set_device(index)


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) -> ``torch.device``;
    raises ``RuntimeError`` when it names CUDA and CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and _rank_device is not None:
        return torch.device("cuda", _rank_device)
    return dev
