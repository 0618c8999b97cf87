"""Vectorized actor: lockstep env stepping + replay insertion
(``deepqlearning_tpu.learner.actor``).

A collect step is ``step((actor, replay, params), generator=None, u=None)
-> (actor, replay, params)``: ε-greedy act → env step → replay insert →
episode bookkeeping, for all E envs at once. Episode-completion aggregates
go into small rings for the recent-average log metric. The rings, the
episode counter and the replay are updated IN PLACE. The step counters
``tick`` and ``t`` are 0-d int64 tensors on the envs' device, advanced by
tensor arithmetic (``ActorState.tick`` / ``t`` of the JAX package are
device int32), so a step reads nothing back to the host. A recurrent network's
state (``net_state``, one entry per layer as ``init_state`` gives it) is
carried from step to step and zeroed where an episode ended.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import counter
from ..envs.base import auto_reset
from ..replay.transition import TransitionBatch

RETURN_RING = 512
T_MAX = 1 << 30  # saturation of the aggregate step counter


class ActorState(NamedTuple):
    env_state: torch.Tensor  # env's batched state, e.g. [E, W]
    obs: torch.Tensor        # [E, *obs_shape]
    net_state: tuple         # network.init_state(E); () if feed-forward
    ep_step: torch.Tensor    # [E] int32 — steps in the current episode
    ep_ret: torch.Tensor     # [E] f32 — return of the current episode
    ret_ring: torch.Tensor   # [RETURN_RING] f32 — per-step ended returns
    ep_count: torch.Tensor   # int32 scalar — completed episodes
    step_ring: torch.Tensor  # [RETURN_RING] f32 — per-step ended lengths
    cnt_ring: torch.Tensor   # [RETURN_RING] f32 — per-step ended counts
    tick: torch.Tensor       # int64 scalar — lockstep step index mod RETURN_RING
    t: torch.Tensor          # int64 scalar — aggregate env steps (saturating)


def init_actor(env, network, num_envs: int, generator: torch.Generator,
               device=None) -> ActorState:
    device = generator.device if device is None else torch.device(device)
    env_state, obs = env.reset_batch(num_envs, generator)
    f32 = dict(dtype=torch.float32, device=device)
    return ActorState(
        env_state=env_state, obs=obs,
        net_state=(network.init_state(num_envs, device)
                   if network.recurrent else ()),
        ep_step=torch.zeros(num_envs, dtype=torch.int32, device=device),
        ep_ret=torch.zeros(num_envs, **f32),
        ret_ring=torch.zeros(RETURN_RING, **f32),
        ep_count=torch.zeros((), dtype=torch.int32, device=device),
        step_ring=torch.zeros(RETURN_RING, **f32),
        cnt_ring=torch.zeros(RETURN_RING, **f32),
        tick=counter(0, device), t=counter(0, device),
    )


def zero_ended(net_state, ended: torch.Tensor):
    """The network state with every stream whose episode ended set to 0."""
    if isinstance(net_state, tuple):
        return tuple(zero_ended(s, ended) for s in net_state)
    return torch.where(ended[:, None], 0.0, net_state)


def _advance(actor: ActorState, env_state, obs, ep_step, ep_ret, totals,
             net_state=()):
    """Write this step's completion aggregates into the rings at the
    device index ``tick`` (in place) and advance the counters."""
    slot = actor.tick.reshape(1)
    for ring, k in ((actor.ret_ring, 0), (actor.step_ring, 1),
                    (actor.cnt_ring, 2)):
        ring.index_copy_(0, slot, totals[k:k + 1].to(ring.dtype))
    actor.ep_count.add_(totals[2].to(torch.int32))
    return actor._replace(
        env_state=env_state, obs=obs, net_state=net_state, ep_step=ep_step,
        ep_ret=ep_ret, tick=(actor.tick + 1) % RETURN_RING,
        t=torch.clamp(actor.t + obs.shape[0], max=T_MAX),
    )


def make_collect_step(env, network, max_episode_length: int, eps_fn,
                      insert_fn, select_fn=None):
    """Plain collect step, with keyed randomness from the generator: for a
    custom ``select_fn(q, t, generator) -> (actions, eps)`` or an env the
    collect kernel does not serve. ``insert_fn(replay, transition, ended)``
    commits the transitions."""
    if select_fn is None:
        from ..solver.exploration import epsilon_greedy_select

        select_fn = epsilon_greedy_select(eps_fn)

    def step(carry, generator=None, u=None):
        if u is not None:
            raise ValueError("the plain collect step draws its own "
                             "randomness; injected uniforms need the "
                             "fused collect step")
        actor, replay, params = carry
        with torch.no_grad():
            q, net_state = network.apply(params, actor.obs, actor.net_state)
        action, _eps = select_fn(q, actor.t, generator)
        env_state, next_obs, reward, done = env.step_batch(
            actor.env_state, action, generator)
        truncate = (actor.ep_step + 1) >= max_episode_length
        ended = torch.logical_or(done > 0.5, truncate)
        replay = insert_fn(replay, TransitionBatch(
            obs=actor.obs, action=action, reward=reward, next_obs=next_obs,
            done=done.float()), ended)
        ep_ret = actor.ep_ret + reward
        ep_step = actor.ep_step + 1
        ended_f = ended.float()
        totals = torch.stack([(ep_ret * ended_f).sum(),
                              (ep_step.float() * ended_f).sum(),
                              ended_f.sum()])
        env_state, obs, _ = auto_reset(env, env_state, next_obs, done,
                                       truncate, generator)
        actor = _advance(
            actor, env_state, obs,
            torch.where(ended, 0, ep_step).to(torch.int32),
            torch.where(ended, 0.0, ep_ret), totals,
            zero_ended(net_state, ended))
        return actor, replay, params

    return step


def avg_recent(ret_ring: torch.Tensor, cnt_ring: torch.Tensor):
    """Mean return over episodes completed in the last RETURN_RING lockstep
    steps."""
    return ret_ring.sum() / torch.clamp(cnt_ring.sum(), min=1.0)


def make_fused_collect_step(env, network, max_episode_length: int, eps_fn,
                            insert_fn, plan):
    """Collect step through kernel K4, or K6 for a recurrent plan
    (``ops/cuda/fused_collect.py``); same step contract. ``u
    [plan.n_uniforms, E]`` (2 + the env's step and reset uniforms: 6 for
    SimpleGridWorld and CartPole, 3 for MountainCar) injects the uniforms;
    otherwise they are drawn with ``torch.rand`` from ``generator`` on the
    envs' device. The cell's state entry of ``net_state`` goes through the
    kernel as one ``[E, S]`` block."""
    from ..ops.cuda.fused_collect import fused_collect

    no = plan.no
    cell = plan.cell

    def step(carry, generator=None, u=None):
        actor, replay, params = carry
        E = actor.obs.shape[0]
        if u is None:
            u = torch.rand(plan.n_uniforms, E, generator=generator,
                           device=actor.obs.device)
        net_state = actor.net_state
        kw = {}
        if cell is not None:
            kw["nstate"] = torch.cat(net_state[cell.layer_idx], dim=1)
        fields, obs_n, state_n, ep_step_n, ep_ret_n, totals, *rest = \
            fused_collect(
                env, plan, params, obs=actor.obs, state=actor.env_state,
                ep_step=actor.ep_step, ep_ret=actor.ep_ret, u=u,
                eps=eps_fn(actor.t), max_episode_length=max_episode_length,
                **kw)
        if cell is not None:
            entry = tuple(rest[0].split(cell.hidden, dim=1))
            net_state = tuple(entry if i == cell.layer_idx else s
                              for i, s in enumerate(net_state))
        obs_shape = tuple(actor.obs.shape[1:])
        transition = TransitionBatch(
            obs=fields[:, :no].reshape((E,) + obs_shape),
            action=fields[:, 2 * no].long(),
            reward=fields[:, 2 * no + 1],
            next_obs=fields[:, no:2 * no].reshape((E,) + obs_shape),
            done=fields[:, 2 * no + 2],
        )
        replay = insert_fn(replay, transition, fields[:, 2 * no + 3] > 0.5)
        actor = _advance(actor, state_n, obs_n.reshape((E,) + obs_shape),
                         ep_step_n, ep_ret_n, totals, net_state)
        return actor, replay, params

    return step
