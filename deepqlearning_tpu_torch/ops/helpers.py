"""Small numeric helpers (``deepqlearning_tpu.ops.helpers``), batch-first."""
from __future__ import annotations

import torch


def flattenbatch(x: torch.Tensor) -> torch.Tensor:
    """Flatten all but the leading (batch) axis."""
    return x.reshape(x.shape[0], -1)


def huber_loss(x: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber loss with delta=1: ``0.5*q^2 + (|x|-q)``,
    ``q = min(|x|, 1)``."""
    abserror = x.abs()
    quadratic = torch.clamp(abserror, max=1.0)
    linear = abserror - quadratic
    return 0.5 * quadratic * quadratic + linear


def globalnorm(grads) -> torch.Tensor:
    """Max absolute entry over all gradient tensors (the reference's
    ``globalnorm`` is a max-abs, not a norm)."""
    grads = list(grads.values()) if isinstance(grads, dict) else list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([g.abs().max() for g in grads]).max()
