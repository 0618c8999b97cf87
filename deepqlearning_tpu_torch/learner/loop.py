"""The (collect → train → maybe-sync-target) iteration
(``deepqlearning_tpu.learner.loop``).

One iteration = ``steps_per_iter`` lockstep env steps feeding the replay,
then ``updates_per_iter`` train updates (one grouped call when grouped),
then a hard target sync on crossing a ``target_update_freq`` boundary.

Routing, feed-forward networks:
* grouped (``updates_per_iter > 1``): kernel K3 when ``plan_for`` supports
  the network (``fused_updates`` None or True), else the plain grouped step,
  its U loss heads kernel K1 unless ``fused_updates=False`` (as the JAX
  package runs its TD kernel there); ``fused_updates=True`` on an
  unsupported network raises.
* ungrouped: ``make_dqn_train_step``, its loss head kernel K1 unless
  ``fused_updates=False``.
Recurrent networks (``cfg.recurrence``, an ``EpisodeReplayBuffer``):
* kernel K5 whenever ``drqn_plan_for`` supports the network and
  ``fused_updates`` is not False, with U = ``updates_per_iter`` sub-updates
  per call when grouped, else U = 1 per call; otherwise the plain grouped
  or ungrouped DRQN step. ``fused_updates=True`` that cannot be honoured
  raises.
Under ``axis_name`` (a ``torch.distributed`` process group or a tuple of
them, innermost first; data parallelism, ``parallel/mesh.py``) the
whole-phase kernels K3 and K5 never run, because their in-kernel Adam
cannot average across ranks: the kernel routes above take kernel K7
(``make_fused_dp_train_step``, grouped feed-forward) or K8
(``make_fused_dp_drqn_train_step``, recurrent) instead, and the plain
steps average their gradients over the axis. Collect is per rank and takes
no collective.
Collect: kernel K4 (K6 for a recurrent network) when ``collect_plan_for``
supports env, network and buffer and no custom ``select_fn`` is given
(``fused_collect`` None or True), else the plain keyed step;
``fused_collect=True`` that cannot be honoured raises.
The kernel wrappers run the CUDA kernels for CUDA tensors and their plain
twins for CPU tensors; nothing here moves work between devices.
Dtypes: the whole-phase and collect kernels (K3/K7, K5/K8, K4/K6) compute
in f32, so they are chosen only when ``cfg.dtype`` is f32, as in the JAX
package; any other dtype (bf16) takes the plain steps and the plain
collect, the grouped feed-forward step still with K1 on f32 casts of its Q
values, and ``fused_updates=True`` or ``fused_collect=True`` with it
raises ``ValueError`` (the JAX package falls back with a warning).

The carry's counters (the actor's ``tick`` and ``t``, the replay's
``insert_pos`` and ``size``, ``sync_acc``, ``iters``) are 0-d int64
tensors on the loop's device and ε is computed from the device ``t``, so
an iteration reads nothing back to the host: ``learner/segment.py``
captures one as a CUDA graph, the counterpart of the JAX package's
``jax.jit(lax.scan(iteration))``.

The random state is one ``torch.Generator`` on the loop's device, in the
carry. Every draw can be replaced by injected uniforms: ``iteration(carry,
collect_u=[u [2 + ns + nr, E] per collect step (the collect plan's
``n_uniforms``)], sample_u=[per train call: u [U·B] for stratified PER, the
Gumbel noise ``[U, leaves]`` for PER without replacement, an
``EpisodeDraws`` for episode replay])``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..config import DQNConfig
from ..device import counter, resolve_device
from ..solver.exploration import ConstantEpsilon
from .actor import ActorState, init_actor, make_collect_step
from .train_step import (
    check_axis,
    make_dqn_train_step,
    make_drqn_train_step,
    make_fused_dp_drqn_train_step,
    make_fused_dp_train_step,
    make_fused_grouped_drqn_train_step,
    make_fused_grouped_train_step,
    make_grouped_dqn_train_step,
    make_grouped_drqn_train_step,
    sync_target,
)


class LoopCarry(NamedTuple):
    actor: ActorState
    replay: object
    params: dict
    target_params: dict
    opt_state: object
    generator: torch.Generator
    loss: torch.Tensor
    gnorm: torch.Tensor
    # env steps accumulated since the last hard target sync (int64 scalar)
    sync_acc: torch.Tensor
    # iterations run on this carry (int64 scalar; local-SGD counts its
    # period by it)
    iters: torch.Tensor


def build_loop(env, network, buffer, cfg: DQNConfig, eps_fn, gamma: float,
               axis_name=None, select_fn=None):
    """Returns ``(iteration, populate_step, optimizer)``.

    ``iteration(carry, collect_u=None, sample_u=None) -> carry``;
    ``populate_step`` is the ε=1 collect step used to pre-fill the replay.
    ``axis_name``: None, or the process group(s) to average gradients over
    (see the module docstring).
    """
    check_axis(axis_name)
    grouped = cfg.grouped_updates and cfg.updates_per_iter > 1
    kernels = cfg.fused_updates is not False
    U = cfg.updates_per_iter if grouped else 1
    f32 = cfg.dtype == torch.float32
    for flag in ("fused_updates", "fused_collect"):
        if getattr(cfg, flag) is True and not f32:
            raise ValueError(
                f"{flag}=True cannot be honoured: the fused kernels compute "
                f"in float32 and dtype is {cfg.dtype}")

    fused = False
    if kernels and f32 and (grouped or cfg.recurrence):
        if cfg.recurrence:
            from ..ops.cuda.fused_drqn import drqn_plan_for as gate

            fused = gate(network, buffer.trace_length, buffer.batch_size,
                         cfg.double_q) is not None
        else:
            from ..ops.cuda.fused_update import plan_for as gate

            fused = gate(network) is not None
        if cfg.fused_updates is True and not fused:
            raise ValueError(
                "fused_updates=True cannot be honoured: the network is not "
                f"supported by the fused update kernel (see {gate.__name__})")
    args = (network, buffer, gamma, cfg.double_q, cfg.learning_rate)
    ax = dict(axis_name=axis_name)
    dp = axis_name is not None
    if cfg.recurrence:
        if not network.recurrent:
            raise ValueError("recurrence=True needs a recurrent network")
        if fused and dp:
            train_step, optimizer = make_fused_dp_drqn_train_step(
                *args, U, axis_name)
        elif fused:
            train_step, optimizer = make_fused_grouped_drqn_train_step(
                *args, U)
        elif grouped:
            train_step, optimizer = make_grouped_drqn_train_step(*args, U,
                                                                 **ax)
        else:
            train_step, optimizer = make_drqn_train_step(*args, **ax)
        insert_fn = buffer.add_step
    else:
        if network.recurrent:
            raise ValueError(
                "DeepQLearningError: a recurrent network needs "
                "recurrence=True")
        if fused and dp:
            train_step, optimizer = make_fused_dp_train_step(*args, U,
                                                             axis_name)
        elif fused:
            train_step, optimizer = make_fused_grouped_train_step(*args, U)
        elif grouped:
            train_step, optimizer = make_grouped_dqn_train_step(
                *args, U, use_kernel=kernels, **ax)
        else:
            train_step, optimizer = make_dqn_train_step(
                *args, use_kernel=kernels, **ax)
        insert_fn = lambda replay, tr, ended: buffer.insert(replay, tr)

    cplan = None
    if cfg.fused_collect is not False and f32:
        from ..ops.cuda.fused_collect import collect_plan_for

        cplan = None if select_fn is not None else collect_plan_for(
            env, network, buffer)
        if cfg.fused_collect is True and cplan is None:
            raise ValueError(
                "fused_collect=True cannot be honoured: the collect kernel "
                "needs the default ε-greedy strategy (no select_fn), an env "
                "it steps (SimpleGridWorld, CartPole or MountainCar), a "
                "supported network (see collect_plan_for) and f32 replay")
    if cplan is not None:
        from .actor import make_fused_collect_step

        collect_step = make_fused_collect_step(
            env, network, cfg.max_episode_length, eps_fn, insert_fn, cplan)
        populate_step = make_fused_collect_step(
            env, network, cfg.max_episode_length, ConstantEpsilon(1.0),
            insert_fn, cplan)
    else:
        collect_step = make_collect_step(
            env, network, cfg.max_episode_length, eps_fn, insert_fn,
            select_fn=select_fn)
        populate_step = make_collect_step(
            env, network, cfg.max_episode_length, ConstantEpsilon(1.0),
            insert_fn)
    tuf = cfg.target_update_freq
    n_calls = cfg.updates_per_iter // U

    def iteration(carry: LoopCarry,
                  collect_u: Optional[Sequence[torch.Tensor]] = None,
                  sample_u: Optional[Sequence[torch.Tensor]] = None
                  ) -> LoopCarry:
        gen = carry.generator
        cc = (carry.actor, carry.replay, carry.params)
        for i in range(cfg.steps_per_iter):
            cc = collect_step(cc, gen,
                              None if collect_u is None else collect_u[i])
        actor, replay, params = cc
        opt_state, loss, gnorm = carry.opt_state, carry.loss, carry.gnorm
        for i in range(n_calls):
            res = train_step(params, carry.target_params, opt_state, replay,
                             u=None if sample_u is None else sample_u[i],
                             generator=gen)
            params, opt_state, replay = (res.params, res.opt_state,
                                         res.replay_state)
            loss, gnorm = res.loss, res.grad_norm
        sync_acc = carry.sync_acc + cfg.env_steps_per_iter
        do_sync = sync_acc >= tuf
        # a count below tuf is its own remainder, so this is the JAX
        # package's where(do_sync, sync_acc % tuf, sync_acc)
        sync_acc = sync_acc % tuf
        target_params = sync_target(params, carry.target_params, do_sync)
        return LoopCarry(actor, replay, params, target_params, opt_state,
                         gen, loss, gnorm, sync_acc, carry.iters + 1)

    return iteration, populate_step, optimizer


def populate(populate_step, buffer, carry: LoopCarry, n_steps: int,
             collect_u: Optional[Sequence[torch.Tensor]] = None) -> LoopCarry:
    """Pre-fill the replay with ``n_steps`` ε=1 collect steps. An episode
    buffer then drops its open episodes (``reset_in_progress``), so that the
    training actor's episodes start fresh; for the recurrent path pass
    ``n_steps = max_episode_length + 1``, so every env has committed an
    episode before the first sample."""
    cc = (carry.actor, carry.replay, carry.params)
    for i in range(n_steps):
        cc = populate_step(cc, carry.generator,
                           None if collect_u is None else collect_u[i])
    replay = cc[1]
    if hasattr(buffer, "reset_in_progress"):
        replay = buffer.reset_in_progress(replay)
    return carry._replace(actor=cc[0], replay=replay)


def init_carry(env, network, buffer, cfg: DQNConfig, optimizer,
               device=None, params=None) -> LoopCarry:
    """A fresh carry on ``device`` (``None``: the buffer's device): one
    generator seeded from ``cfg.seed`` draws the initial parameters in
    ``cfg.dtype`` (unless given) and the envs' first states; the target network starts as a copy
    of the parameters. Raises ``ValueError`` when the network's parameters
    (or the given ``params``) lie on another device: nothing is moved."""
    device = resolve_device(buffer.device if device is None else device)
    held = list(params.values()) if params is not None else \
        list(network.parameters())
    index = lambda d: (torch.cuda.current_device() if d.index is None
                       else d.index)
    for p in held:
        if p.device.type != device.type or (
                device.type == "cuda" and index(p.device) != index(device)):
            raise ValueError(
                f"init_carry: the network's parameters are on {p.device} but "
                f"the carry is on {device} (the buffer is on "
                f"{buffer.device}); build or move the network there first")
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    if params is None:
        params = network.init(gen, cfg.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return LoopCarry(
        actor=init_actor(env, network, cfg.num_envs, gen, device),
        replay=buffer.init(), params=params,
        target_params={k: p.clone() for k, p in params.items()},
        opt_state=optimizer.init(params), generator=gen,
        loss=zero, gnorm=zero.clone(), sync_acc=counter(0, device),
        iters=counter(0, device),
    )
