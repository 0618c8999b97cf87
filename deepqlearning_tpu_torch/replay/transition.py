"""Transition records (``deepqlearning_tpu.replay.transition``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class DQExperience(NamedTuple):
    """Single transition (s, a, r, sp, done)."""

    s: torch.Tensor
    a: int
    r: float
    sp: torch.Tensor
    done: bool


class TransitionBatch(NamedTuple):
    """Struct-of-arrays batch of transitions; leading axis is batch."""

    obs: torch.Tensor       # [B, *obs_shape] f32
    action: torch.Tensor    # [B] int
    reward: torch.Tensor    # [B] f32
    next_obs: torch.Tensor  # [B, *obs_shape] f32
    done: torch.Tensor      # [B] f32 (0/1)


def batch_from_experience(exp: DQExperience, device=None) -> TransitionBatch:
    """A batch of one from one ``DQExperience``: the host path's insert
    unit, on ``device``."""
    return TransitionBatch(
        obs=torch.as_tensor(exp.s, device=device)[None],
        action=torch.tensor([exp.a], dtype=torch.long, device=device),
        reward=torch.tensor([exp.r], dtype=torch.float32, device=device),
        next_obs=torch.as_tensor(exp.sp, device=device)[None],
        done=torch.tensor([float(exp.done)], device=device))
