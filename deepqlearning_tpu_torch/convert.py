"""Moving state between the JAX package and the port, as numpy arrays.

The JAX package keeps a network's parameters as a pytree (a ``Chain`` is a
tuple with one dict per layer, ``{"w": [din, dout], "b": [dout]}`` for
Dense, ``{"wi", "wh", "b"}`` for LSTM/GRU and ``{}`` otherwise; a
``DuelingNetwork`` is ``{"base", "val", "adv"}``). The port keeps the same arrays in a dict keyed like
``named_parameters()``, in the same ``w [din, dout]`` layout, so the map is
1:1 with no transpose. The helpers take numpy copies of JAX state, e.g.
``jax.tree_util.tree_map(np.asarray, params)``; this module imports no JAX.

Dtypes cross as they are: a leaf keeps its dtype, and a bf16 array (numpy
holds it as ``ml_dtypes.bfloat16``, which ``torch.tensor`` refuses) crosses
as its 16-bit pattern, so bf16 parameters, Adam moments, replay rows and
episode rings (uint8 ones too) cross bit for bit; :func:`params_to_numpy`
gives bf16 back as ``ml_dtypes.bfloat16`` (imported only then, as the
JAX side has it).

A JAX ``DataParallelRunner`` carry stacks every device's shard on leading
mesh axes; :func:`loop_carry_from_numpy` takes one shard of it as one
rank's ``LoopCarry``, and :func:`adam_from_optax` reads the
``optax.flatten(adam)`` state of the plain and data-parallel paths.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .device import counter
from .learner.actor import ActorState
from .learner.loop import LoopCarry
from .learner.train_step import AdamState
from .models.chain import GRU, LSTM, Chain, Conv2D, Dense, params_of
from .models.dueling import DuelingNetwork
from .replay.episode import EpisodeReplayState
from .replay.prioritized import ReplayState

_CELL_KEYS = ("wi", "wh", "b")


def _walk(module, tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(parameter name, leaf of ``tree``) pairs in module order."""
    if isinstance(module, DuelingNetwork):
        for part in ("base", "val", "adv"):
            yield from _walk(getattr(module, part), tree[part],
                             f"{prefix}{part}.")
    elif isinstance(module, Chain):
        for i, (layer, sub) in enumerate(zip(module.layers, tree)):
            yield from _walk(layer, sub, f"{prefix}layers.{i}.")
    elif isinstance(module, (Dense, Conv2D)):
        yield prefix + "w", tree["w"]
        if getattr(module, "use_bias", True):
            yield prefix + "b", tree["b"]
    elif isinstance(module, (LSTM, GRU)):
        for k in _CELL_KEYS:
            yield prefix + k, tree[k]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A tensor of the array's dtype and bits: bf16 through its uint16
    pattern; float64 (numpy's default, never a JAX leaf here) as f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`tensor_from_numpy`: bf16 as
    ``ml_dtypes.bfloat16`` with the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _as_dict(network, tree, device) -> Dict[str, torch.Tensor]:
    return {name: tensor_from_numpy(leaf, device)
            for name, leaf in _walk(network, tree)}


def params_from_numpy(network, tree) -> Dict[str, torch.Tensor]:
    """Copy a JAX param pytree (numpy leaves) into the network's parameters,
    in place, each parameter taking its leaf's dtype, and return the port's
    parameter dict."""
    device = next(network.parameters()).device
    new = _as_dict(network, tree, device)
    named = dict(network.named_parameters())
    if new.keys() != named.keys():
        raise ValueError(f"parameter names differ: {sorted(new)} vs "
                         f"{sorted(named)}")
    with torch.no_grad():
        for k, t in new.items():
            if named[k].dtype != t.dtype:
                named[k].data = named[k].data.to(t.dtype)
            named[k].copy_(t)
    return params_of(network)


def params_to_numpy(network, params: Dict[str, torch.Tensor]):
    """The port's parameter dict as a JAX-shaped pytree of numpy arrays."""
    def build(module, prefix=""):
        if isinstance(module, DuelingNetwork):
            return {part: build(getattr(module, part), f"{prefix}{part}.")
                    for part in ("base", "val", "adv")}
        if isinstance(module, Chain):
            return tuple(build(l, f"{prefix}layers.{i}.")
                         for i, l in enumerate(module.layers))
        if isinstance(module, (Dense, Conv2D)):
            out = {"w": tensor_to_numpy(params[prefix + "w"])}
            if getattr(module, "use_bias", True):
                out["b"] = tensor_to_numpy(params[prefix + "b"])
            return out
        if isinstance(module, (LSTM, GRU)):
            return {k: tensor_to_numpy(params[prefix + k])
                    for k in _CELL_KEYS}
        return {}

    return build(network)


def adam_from_numpy(network, m_tree, v_tree, count, device=None) -> AdamState:
    """``AdamState`` from JAX Adam moments shaped like the params (the
    fused path's ``FusedAdamState``) and its step count."""
    return AdamState(
        m=_as_dict(network, m_tree, device), v=_as_dict(network, v_tree, device),
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
    )


def gridworld_state_from_numpy(pos, terminal, device=None) -> torch.Tensor:
    """JAX ``GridWorldState`` (pos [E, 2] int, terminal [E] bool) -> the
    port's ``[E, 3]`` f32 block."""
    pos = np.asarray(pos, np.float32)
    term = np.asarray(terminal, np.float32)[:, None]
    return torch.tensor(np.concatenate([pos, term], axis=1), device=device)


def env_state_from_numpy(state, device=None) -> torch.Tensor:
    """A JAX env state NamedTuple whose leaves were copied to numpy (one
    array ``[E]`` per field, or ``[E, 2]`` for the grid's ``pos``) -> the
    port's batched ``[E, W]`` f32 block: ``GridWorldState`` as
    :func:`gridworld_state_from_numpy`; ``CartPoleState``,
    ``MountainCarState`` and ``AcrobotState`` as their fields in order, the
    JAX cols rows transposed."""
    if hasattr(state, "pos") and hasattr(state, "terminal"):
        return gridworld_state_from_numpy(state.pos, state.terminal, device)
    cols = [np.asarray(x, np.float32) for x in state]
    return torch.tensor(np.stack(cols, axis=1), device=device)


def net_state_from_numpy(tree, device=None):
    """A network state (nested tuples of numpy arrays, one entry per layer)
    as the same tuples of f32 tensors; ``()`` when it holds no array (a
    feed-forward network's state, as the port's actor keeps it)."""
    def build(x):
        if isinstance(x, (tuple, list)):
            return tuple(build(y) for y in x)
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def has_leaf(x):
        return (any(has_leaf(y) for y in x) if isinstance(x, (tuple, list))
                else True)

    return build(tree) if has_leaf(tree) else ()


def actor_from_numpy(actor, device=None) -> ActorState:
    """The port's ``ActorState`` from a JAX ``ActorState`` whose leaves were
    copied to numpy (the env states of :func:`env_state_from_numpy`, any
    network state)."""
    t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x),
                                                 device=device).to(dt)
    return ActorState(
        env_state=env_state_from_numpy(actor.env_state, device),
        obs=t(actor.obs), net_state=net_state_from_numpy(actor.net_state,
                                                         device),
        ep_step=t(actor.ep_step, torch.int32), ep_ret=t(actor.ep_ret),
        ret_ring=t(actor.ret_ring), ep_count=t(actor.ep_count, torch.int32),
        step_ring=t(actor.step_ring), cnt_ring=t(actor.cnt_ring),
        tick=counter(int(actor.tick), device),
        t=counter(int(actor.t), device),
    )


def replay_from_numpy(rows, tree, insert_pos, size, device=None
                      ) -> ReplayState:
    """The port's ``ReplayState`` from a JAX ``ReplayState``'s numpy copies
    (rows ``[C, 2no + 4·ratio]`` in the storage dtype, bit for bit; tree
    levels leaves first)."""
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return ReplayState(rows=tensor_from_numpy(rows, device),
                       tree=tuple(t(l) for l in tree),
                       insert_pos=counter(int(insert_pos), device),
                       size=counter(int(size), device))


def episode_replay_from_numpy(state, device=None) -> EpisodeReplayState:
    """The port's ``EpisodeReplayState`` from a JAX ``EpisodeReplayState``'s
    numpy copies (the ring in its storage dtype, bit for bit). The JAX ring
    ``[R+T-1, E/G, G·F]`` groups G envs per row; the port's ``[R+T-1, E,
    F]`` is the same memory."""
    i32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32,
                                 device=device)
    data = tensor_from_numpy(state.data, device)
    E = np.asarray(state.rec_count).shape[0]
    return EpisodeReplayState(
        data=data.reshape(data.shape[0], E, -1),
        ep_start=i32(state.ep_start), ep_len=i32(state.ep_len),
        rec_count=i32(state.rec_count), cur_len=i32(state.cur_len),
        t=int(state.t))


def _jax_leaves(tree, prefix: str = ""):
    """(parameter name, leaf) pairs of a JAX param pytree in JAX's flatten
    order (dict keys sorted, sequences in order): the order in which
    ``optax.flatten`` ravels the Adam moments."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _jax_leaves(sub, f"{prefix}layers.{i}.")
    else:
        yield prefix[:-1], tree


def adam_from_optax(params_tree, opt_state, device=None) -> AdamState:
    """``AdamState`` from the ``optax.flatten(optax.adam(...))`` state
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` of the JAX plain
    and data-parallel train steps, whose ``mu``/``nu`` are the moments
    raveled in the flatten order of ``params_tree`` (numpy leaves), in
    their dtype (bf16 moments of bf16 parameters)."""
    adam = opt_state[0]
    mu = tensor_from_numpy(adam.mu, device)
    nu = tensor_from_numpy(adam.nu, device)
    m, v, off = {}, {}, 0
    for name, leaf in _jax_leaves(params_tree):
        shape = np.shape(leaf)
        k = int(np.prod(shape))
        m[name] = mu[off:off + k].reshape(shape).clone()
        v[name] = nu[off:off + k].reshape(shape).clone()
        off += k
    if off != mu.numel():
        raise ValueError(f"moments hold {mu.numel()} values, the params "
                         f"{off}")
    return AdamState(m=m, v=v, count=torch.tensor(
        int(adam.count), dtype=torch.int32, device=device))


def _take(tree, index):
    """Entry ``index`` of every array leaf of a (nested tuple / NamedTuple /
    dict) tree; other leaves as they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_take(x, index) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(x, index) for x in tree)
    if isinstance(tree, dict):
        return {k: _take(x, index) for k, x in tree.items()}
    if isinstance(tree, np.ndarray):
        return tree[index]
    return tree


def loop_carry_from_numpy(network, carry, index=None, device=None,
                          generator=None) -> LoopCarry:
    """One rank's ``LoopCarry`` from a JAX ``LoopCarry`` whose leaves were
    copied to numpy: shard ``index`` (``d`` on a 1-D mesh, ``(i, j)`` on a
    2-D one) of a ``DataParallelRunner`` carry, or the whole carry when
    ``index`` is None. The actors of
    :func:`actor_from_numpy`; PER or episode replay; the
    ``optax.flatten`` Adam state. The JAX keys have no counterpart: the
    rank's ``generator`` (default: a fresh one seeded 0) takes their
    place."""
    c = carry if index is None else _take(carry, index)
    if hasattr(c.replay, "rows"):
        replay = replay_from_numpy(c.replay.rows, c.replay.tree,
                                   c.replay.insert_pos, c.replay.size, device)
    else:
        replay = episode_replay_from_numpy(c.replay, device)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    return LoopCarry(
        actor=actor_from_numpy(c.actor, device), replay=replay,
        params=_as_dict(network, c.params, device),
        target_params=_as_dict(network, c.target_params, device),
        opt_state=adam_from_optax(c.params, c.opt_state, device),
        generator=generator, loss=f32(c.loss), gnorm=f32(c.gnorm),
        sync_acc=counter(int(c.sync_acc), device),
        iters=counter(0, device))
