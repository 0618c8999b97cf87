"""Solver configuration, field for field with ``deepqlearning_tpu.config``.

The defaults, the derived iteration sizes and the ``num_envs``/``train_freq``
nesting check are those of the JAX package. Two fields change meaning:

* ``dtype`` is a torch dtype (or its name, e.g. ``"bfloat16"``). It
  reaches both the network's parameters and the replay storage
  (``solver/solver.py``); the kernels that compute in f32 are chosen only
  for ``torch.float32`` (``learner/loop.py``).
* ``fused_updates`` / ``fused_collect``: ``None`` takes the kernel route
  whenever the network, env and buffer are supported, on any device. The
  kernel wrappers then dispatch on the tensors they are given: the CUDA
  kernel for CUDA tensors, its plain PyTorch twin for CPU tensors. ``True``
  demands the kernel route and raises if it cannot be honoured; ``False``
  selects the plain composition path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    # --- reference parity fields ---
    learning_rate: float = 1e-4
    max_steps: int = 1000
    batch_size: int = 32
    train_freq: int = 4
    eval_freq: int = 500
    target_update_freq: int = 500
    num_ep_eval: int = 100
    double_q: bool = True
    dueling: bool = True
    recurrence: bool = False
    trace_length: int = 40
    prioritized_replay: bool = True
    prioritized_replay_alpha: float = 0.6
    prioritized_replay_beta: float = 0.4
    prioritized_replay_epsilon: float = 1e-3
    prioritized_sample_mode: str = "stratified"
    buffer_size: int = 1000
    max_episode_length: int = 100
    train_start: int = 200
    seed: int = 0
    logdir: Optional[str] = "log/"
    save_freq: int = 3000
    log_freq: int = 100
    verbose: bool = True

    # --- vectorized extensions ---
    num_envs: int = 1
    dtype: Any = torch.float32
    grouped_updates: bool = True
    fused_updates: Optional[bool] = None
    fused_collect: Optional[bool] = None
    data_axis: str = "data"

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            object.__setattr__(self, "dtype", getattr(torch, str(self.dtype)))
        if self.num_envs % self.train_freq and self.train_freq % self.num_envs:
            raise ValueError(
                f"num_envs ({self.num_envs}) and train_freq "
                f"({self.train_freq}) must divide one another so the "
                "data/update ratio is exact; pick train_freq a multiple of "
                "num_envs (train less often than every lockstep step) or "
                "num_envs a multiple of train_freq (grouped updates)"
            )

    def replace(self, **kw) -> "DQNConfig":
        return dataclasses.replace(self, **kw)

    @property
    def steps_per_iter(self) -> int:
        """Env steps (per env) collected between consecutive train updates."""
        return max(1, self.train_freq // self.num_envs)

    @property
    def updates_per_iter(self) -> int:
        """Train updates performed after each collect phase."""
        return max(1, (self.num_envs * self.steps_per_iter) // self.train_freq)

    @property
    def env_steps_per_iter(self) -> int:
        """Aggregate env steps per (collect, train) iteration."""
        return self.num_envs * self.steps_per_iter
