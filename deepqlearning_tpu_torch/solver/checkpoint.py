"""Best-model and train-state checkpoints
(``deepqlearning_tpu.solver.checkpoint``).

``save_model`` saves the Q-network's parameters whenever an eval score
beats (or ties) the best so far; ``solve`` restores the best at the end and
``restore_best_model`` rebuilds a policy from them. ``save_train_state`` /
``load_train_state`` hold the whole ``LoopCarry`` so that ``solve(...,
resume=True)`` continues where the last solve stopped.

The files are ``torch.save`` archives read with ``torch.load(...,
weights_only=True)``, where the JAX package writes flax msgpack: a tree of
dicts, tuples, lists, CPU tensors and host numbers. NamedTuples are stored
by field name, a ``torch.Generator`` by its state, and the carry's
counters (``ActorState.t`` / ``tick``, the replay's ``insert_pos`` /
``size``, ``LoopCarry.sync_acc`` / ``iters``: 0-d device tensors) as
tensors; the episode replay's host ``t`` as it is. Loading fills a
template of the same structure: tensors are copied into the template's
tensors in place (so a parameter dict keeps sharing its module's storage,
and a carry that a CUDA graph replays keeps its buffers), generators take
the saved state, host numbers are replaced. A tensor keeps
its dtype (bf16 parameters, moments and replay rows of a bf16 solve); a
saved dtype other than the template's raises.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

CKPT_NAME = "qnetwork.pt"
TRAIN_STATE_NAME = "train_state.pt"
_GEN = "__generator__"
_FIELDS = "__fields__"


def _pack(obj):
    if isinstance(obj, torch.Generator):
        return {_GEN: obj.get_state()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {_FIELDS: {k: _pack(v) for k, v in obj._asdict().items()}}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_pack(v) for v in obj)
    return obj


@torch.no_grad()
def _fill(template, saved, path: str = "state"):
    if isinstance(template, torch.Generator):
        template.set_state(saved[_GEN])
        return template
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"{path}: saved shape {tuple(saved.shape)}, "
                             f"expected {tuple(template.shape)}")
        if saved.dtype != template.dtype:
            raise ValueError(f"{path}: saved dtype {saved.dtype}, expected "
                             f"{template.dtype}")
        template.copy_(saved)
        return template
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        fields = saved[_FIELDS]
        return type(template)(**{
            k: _fill(v, fields[k], f"{path}.{k}")
            for k, v in template._asdict().items()})
    if isinstance(template, dict):
        if set(saved) != set(template):
            raise ValueError(f"{path}: saved keys {sorted(saved)}, expected "
                             f"{sorted(template)}")
        return {k: _fill(v, saved[k], f"{path}.{k}")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        if len(saved) != len(template):
            raise ValueError(f"{path}: saved {len(saved)} entries, expected "
                             f"{len(template)}")
        return type(template)(_fill(t, s, f"{path}[{i}]")
                              for i, (t, s) in enumerate(zip(template, saved)))
    return saved


def save_params(logdir: str, params) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, CKPT_NAME)
    torch.save(_pack(params), path)
    return path


def load_params(logdir: str, params_template):
    """The saved parameters, copied into ``params_template``'s tensors."""
    path = os.path.join(logdir, CKPT_NAME)
    return _fill(params_template, torch.load(path, weights_only=True),
                 "params")


def save_train_state(logdir: str, carry) -> str:
    """The full resume checkpoint: the carry's tensors (its counters
    included), host numbers and generator state."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRAIN_STATE_NAME)
    torch.save(_pack(carry), path)
    return path


def load_train_state(logdir: str, carry_template):
    """The saved training state, filled into ``carry_template``."""
    path = os.path.join(logdir, TRAIN_STATE_NAME)
    return _fill(carry_template, torch.load(path, weights_only=True),
                 "carry")


def save_model(logdir: Optional[str], params, scores_eval: float,
               saved_mean_reward: float, model_saved: bool,
               verbose: bool) -> Tuple[bool, float]:
    """Save iff the eval score beats (or ties) the best so far; returns
    ``(model_saved, best)``."""
    if scores_eval >= saved_mean_reward:
        if logdir is not None:
            save_params(logdir, params)
        if verbose:
            print(f"Saving new model with eval reward {scores_eval:1.3f}")
        return True, scores_eval
    return model_saved, saved_mean_reward
