"""Environment protocol (``deepqlearning_tpu.envs.base``).

An env is written in either of two forms, and the base class supplies the
other:

* one instance at a time, as the JAX package asks of its envs::

      env.reset(generator)                 -> (state, obs)
      env.step(state, action, generator)   -> (state, obs, reward, done)
      env.observe(state)                   -> obs

  ``state`` is any pytree of tensors of one instance (a tensor, a tuple, a
  NamedTuple), ``action`` a 0-d int tensor. The default batched methods run
  these through ``torch.func.vmap(..., randomness="different")``, the
  counterpart of the JAX ``jax.vmap(self.reset)(keys)``: each per-instance
  op becomes one op over the batch, and each draw from ``generator`` one
  draw of ``E`` values (``torch.rand((), generator=g)`` inside ``step``
  draws the row that ``torch.rand(E, generator=g)`` would). The usual
  ``vmap`` rules hold: no Python control flow on tensor values (``if x >
  0``, ``.item()``, ``int(x)``), and every tensor made on
  ``generator.device``; an output on another device raises.

* batched, every tensor with a leading batch axis ``[E, ...]``::

      env.reset_batch(num, generator)           -> (state, obs)
      env.step_batch(state, action, generator)  -> (state, obs, reward, done)
      env.observe_batch(state)                  -> obs

  The built-in envs are written so (their collect kernels read the same
  dynamics from ``step_cols`` / ``reset_cols``) and give their per-instance
  methods as the batched code at one row.

On the card, ``solve`` captures an env of either form into one CUDA graph
per iteration and replays it (``learner/segment.py``): the batched methods,
or the per-instance ``reset`` / ``step`` / ``observe`` through the vmapped
defaults, run once at capture and never again. So they must be pure device
code: no host read (``.item()``, ``bool(t)``, ``int(t)``, a shape taken
from data), no host-to-device copy of a host tensor, and nothing kept or
drawn on the host between calls (a Python counter such as ``self.steps +=
1``, a host random number, Python-side state), which every replay would
repeat as it was at capture. Draw only from the ``generator`` passed in:
it is the carry's, registered with the graph, so each replay draws fresh
numbers, each vmapped draw the row that ``torch.rand(E, generator=g)``
would give. The capture raises on a host read; the segment raises on the
others where its first replay differs from the eager iteration.

The loop consumes the batched form: ``obs`` ``[E, *obs_shape]``, ``action``
``[E]`` int, ``reward``/``done`` ``[E]`` f32 (the vmapped defaults cast a
per-instance reward or bool ``done`` to f32).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

_FORMS = ("the per-instance reset(generator) / step(state, action, "
          "generator) / observe(state), or the batched reset_batch(num, "
          "generator) / step_batch(state, action, generator) / "
          "observe_batch(state)")


class Env:
    """Base class for environments.

    Subclasses define ``num_actions``, ``obs_shape``, ``discount`` and
    either form of the methods (module docstring)."""

    num_actions: int
    obs_shape: Tuple[int, ...]
    discount: float = 1.0

    @property
    def action_map(self) -> Sequence[Any]:
        return list(range(self.num_actions))

    # --- one instance ---------------------------------------------------
    def reset(self, generator: torch.Generator):
        """Default: row 0 of ``reset_batch(1, generator)``."""
        _needs(self, "reset_batch")
        return first_row(self.reset_batch(1, generator))

    def step(self, state, action, generator: torch.Generator):
        """Default: row 0 of ``step_batch`` on a batch of one."""
        _needs(self, "step_batch")
        state, action = batch_of_one(state, action)
        return first_row(self.step_batch(state, action, generator))

    def observe(self, state):
        """Default: row 0 of ``observe_batch`` on a batch of one."""
        _needs(self, "observe_batch")
        return first_row(self.observe_batch(batch_of_one(state)))

    # --- a batch --------------------------------------------------------
    def reset_batch(self, num: int, generator: torch.Generator):
        """Default: ``reset`` vmapped over ``num`` instances."""
        _needs(self, "reset")
        device = generator.device
        return _vmapped(self, "reset", lambda _: self.reset(generator),
                        device, torch.empty(num, device=device))

    def step_batch(self, state, action, generator: torch.Generator):
        """Default: ``step`` vmapped over the rows; reward and done as f32."""
        _needs(self, "step")
        device = action.device if generator is None else generator.device
        sp, obs, r, done = _vmapped(
            self, "step", lambda s, a: self.step(s, a, generator), device,
            state, action)
        return sp, obs, r.float(), done.float()

    def observe_batch(self, state):
        """Default: ``observe`` vmapped over the rows."""
        _needs(self, "observe")
        device = tree_leaves(state)[0].device
        return _vmapped(self, "observe", self.observe, device, state)


def _needs(env: Env, name: str):
    """Raise unless ``env``'s class defines ``name`` itself: a default of
    one form calls only a method of the other that a subclass gave."""
    if getattr(type(env), name) is getattr(Env, name):
        raise NotImplementedError(
            f"{type(env).__name__} defines neither form of the env "
            f"protocol: give {_FORMS}")


def batch_of_one(*trees):
    """Each instance pytree as a batch of one (a leading axis of 1); a
    Python number becomes a tensor on the device of the first tensor."""
    leaves = [x for x in tree_leaves(trees) if torch.is_tensor(x)]
    device = leaves[0].device if leaves else None
    out = tree_map(lambda x: torch.as_tensor(x, device=device)[None], trees)
    return out[0] if len(trees) == 1 else out


def first_row(tree):
    """Row 0 of every tensor of a batched pytree."""
    return tree_map(lambda x: x[0], tree)


def _vmapped(env: Env, name: str, fn, device: torch.device, *args):
    """``fn`` vmapped over the leading axis of ``args`` with a draw of its
    own for each row; outputs contiguous (an output that does not depend
    on the row comes back as a stride-0 view, which an in-place write
    would refuse). An output off ``device`` raises ``RuntimeError``."""
    try:
        out = torch.func.vmap(fn, randomness="different")(*args)
    except Exception as e:
        e.add_note(
            f"in {type(env).__name__}.{name}, batched by torch.func.vmap: "
            "per-instance code takes no Python control flow on tensor "
            "values (if x > 0, .item(), int(x)) and makes tensors on "
            "generator.device")
        raise
    for x in tree_leaves(out):
        if x.device.type != device.type or (
                device.index is not None and x.device.index != device.index):
            raise RuntimeError(
                f"{type(env).__name__}.{name} returned a tensor on "
                f"{x.device} for a batch on {device}: make tensors on "
                "generator.device")
    return tree_map(lambda x: x.contiguous(), out)


def auto_reset(env: Env, state, obs, done, truncate, generator):
    """Where an episode ended (done or truncated), replace (state, obs) with
    a fresh reset, leaf by leaf of the state pytree (its type kept).
    Returns ``(state, obs, ended)``."""
    ended = torch.logical_or(done.bool(), truncate.bool())
    fresh_state, fresh_obs = env.reset_batch(done.shape[0], generator)

    def pick(a, b):
        return torch.where(ended.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return tree_map(pick, fresh_state, state), pick(fresh_obs, obs), ended
