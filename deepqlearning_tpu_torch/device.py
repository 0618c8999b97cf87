"""The device an entry point runs on when the caller names none.

The port's entry points (``init_carry``, the replay buffers) run on the
card: ``device=None`` means ``cuda``. Without CUDA they raise rather than
fall back to the CPU, so a run that was meant for the card never measures
the CPU by accident; CPU runs (the tests) pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``, which
    raises ``RuntimeError`` when no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "the caller asks for the CPU; pass device=\"cpu\" to run there")
    return torch.device("cuda")
