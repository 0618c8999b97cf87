"""Profiling and debug hooks (``deepqlearning_tpu.utils.profiling``).

``trace(logdir)`` records a ``torch.profiler`` trace (host, and the card's
kernels when CUDA is available) into ``logdir`` for TensorBoard or
Perfetto; ``enable_nan_checks`` turns on autograd's anomaly detection, which
raises where a backward pass produces NaN.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace into ``logdir``."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def enable_nan_checks(enabled: bool = True):
    """Anomaly mode: a backward pass that produces NaN raises."""
    torch.autograd.set_detect_anomaly(enabled)


class StepTimer:
    """Cheap wall-clock EMA of host-loop segment times for the logger."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema
            )
        self._last = now
        return self.ema
