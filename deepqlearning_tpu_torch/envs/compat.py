"""Host-environment path (``deepqlearning_tpu.envs.compat``).

``HostEnv`` is the mutable ``reset / observe / act / terminated / actions``
protocol of an env that cannot be batched, stepped on the host one step at
a time, while action selection and the train step run on the solver's
device: ``make_dqn_train_step`` (its loss head kernel K1 on the card) or
``make_drqn_train_step``. Throughput is host-bound by construction; this
path exists for generality, the batched ``Env`` is the fast path.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..replay.transition import DQExperience, batch_from_experience


class HostEnv:
    """Mutable single env. Subclass and implement ``reset()``,
    ``observe() -> np.ndarray``, ``act(action) -> float``, ``terminated()
    -> bool`` and ``actions() -> list``; ``discount`` defaults to 1."""

    discount: float = 1.0

    def reset(self):
        raise NotImplementedError

    def observe(self) -> np.ndarray:
        raise NotImplementedError

    def act(self, action) -> float:
        raise NotImplementedError

    def terminated(self) -> bool:
        raise NotImplementedError

    def actions(self) -> Sequence[Any]:
        raise NotImplementedError


def _host_eval(policy, env: HostEnv, n_eval: int, max_episode_length: int):
    """Serial greedy rollouts: mean undiscounted return and steps."""
    avg_r, avg_steps = 0.0, 0.0
    for _ in range(n_eval):
        env.reset()
        policy.reset_state()
        obs = np.asarray(env.observe(), np.float32)
        r_tot, step = 0.0, 0
        while not env.terminated() and step <= max_episode_length:
            a = policy.action(obs)
            r_tot += float(env.act(a))
            obs = np.asarray(env.observe(), np.float32)
            step += 1
        avg_r += r_tot
        avg_steps += step
    return avg_r / n_eval, avg_steps / n_eval, {}


def _run_eval(solver, policy, env: HostEnv, cfg):
    """The default ``basic_evaluation`` cannot drive a host env, so it maps
    to the serial rollout; a custom strategy is called with the standard
    signature and a generator seeded ``seed + 1``."""
    from ..solver.evaluation import basic_evaluation

    if solver.evaluation_policy is basic_evaluation:
        return _host_eval(policy, env, cfg.num_ep_eval,
                          cfg.max_episode_length)
    generator = torch.Generator(device=policy.device).manual_seed(
        cfg.seed + 1)
    return solver.evaluation_policy(
        policy.network, policy.params, env, cfg.num_ep_eval,
        cfg.max_episode_length, generator, cfg.verbose)


def solve_host(solver, env: HostEnv):
    """The serial training loop over a host env, feed-forward or
    recurrent; returns the greedy ``NNPolicy``."""
    from ..learner.train_step import (
        make_dqn_train_step, make_drqn_train_step, sync_target)
    from ..solver import checkpoint
    from ..solver.exploration import eps_schedule
    from ..solver.policy import NNPolicy
    from ..solver.solver import role_generators

    cfg = solver.config
    device = resolve_device(solver.device)
    action_map = list(env.actions())
    network = solver._build_network(device)
    env.reset()
    obs_shape = np.asarray(env.observe(), np.float32).shape
    buffer = _make_host_buffer(solver, obs_shape, device)
    gamma = float(getattr(env, "discount", 1.0))
    gens = role_generators(cfg.seed, device)
    params = network.init(gens["init"])
    target_params = {k: p.clone() for k, p in params.items()}

    args = (network, buffer, gamma, cfg.double_q, cfg.learning_rate)
    if cfg.recurrence:
        train_step, optimizer = make_drqn_train_step(*args)
    else:
        train_step, optimizer = make_dqn_train_step(
            *args, use_kernel=cfg.fused_updates is not False)
    opt_state = optimizer.init(params)
    replay = buffer.init()

    policy = NNPolicy(env, network, params, action_map, len(obs_shape))
    rng = np.random.RandomState(cfg.seed)
    logger = None
    if solver.logdir is not None:
        from ..utils.tb_writer import TBWriter

        logger = TBWriter(solver.logdir)
        solver.logdir = logger.logdir

    # None: a function-valued strategy f(policy, env, obs, t, rng)
    eps_fn = eps_schedule(solver.exploration_policy)

    def push(replay, o, a, r, op, done, ended):
        tr = batch_from_experience(DQExperience(s=o, a=a, r=r, sp=op,
                                                done=done), device)
        if cfg.recurrence:
            return buffer.add_step(
                replay, tr, torch.tensor([ended], device=device))
        return buffer.insert(replay, tr)

    # --- populate with a random policy ---
    env.reset()
    obs = np.asarray(env.observe(), np.float32)
    step = 0
    for _ in range(cfg.train_start):
        ai = rng.randint(len(action_map))
        r = float(env.act(action_map[ai]))
        op = np.asarray(env.observe(), np.float32)
        done = bool(env.terminated())
        step += 1
        ended = done or step >= cfg.max_episode_length
        replay = push(replay, obs, ai, r, op, done, ended)
        obs = op
        if ended:
            env.reset()
            obs = np.asarray(env.observe(), np.float32)
            step = 0
    if cfg.recurrence:
        # training episodes must not continue the populate's open ones
        replay = buffer.reset_in_progress(replay)

    # --- training loop ---
    env.reset()
    policy.reset_state()
    obs = np.asarray(env.observe(), np.float32)
    step = 0
    saved_mean_reward = -math.inf
    scores_eval = -math.inf
    model_saved = eval_next = save_next = False
    loss_val = grad_val = 0.0
    a_index = {a: i for i, a in enumerate(action_map)}

    for t in range(1, cfg.max_steps + 1):
        if eps_fn is None:
            act, _eps = solver.exploration_policy(policy, env, obs, t, rng)
            ai = a_index[act]
        elif rng.rand() < float(eps_fn(t)):
            ai = rng.randint(len(action_map))
        else:
            ai = a_index[policy.action(obs)]
        r = float(env.act(action_map[ai]))
        op = np.asarray(env.observe(), np.float32)
        done = bool(env.terminated())
        step += 1
        ended = done or step >= cfg.max_episode_length
        replay = push(replay, obs, ai, r, op, done, ended)
        obs = op

        if ended:
            if eval_next:
                scores_eval, _steps, _info = _run_eval(solver, policy, env,
                                                       cfg)
                eval_next = False
                if save_next:
                    model_saved, saved_mean_reward = checkpoint.save_model(
                        solver.logdir, policy.params, scores_eval,
                        saved_mean_reward, model_saved, cfg.verbose)
                    save_next = False
            env.reset()
            policy.reset_state()
            obs = np.asarray(env.observe(), np.float32)
            step = 0

        if t % cfg.train_freq == 0:
            res = train_step(params, target_params, opt_state, replay,
                             generator=gens["learn"])
            params, opt_state, replay = (res.params, res.opt_state,
                                         res.replay_state)
            loss_val, grad_val = float(res.loss), float(res.grad_norm)
        if t % cfg.target_update_freq == 0:
            target_params = sync_target(
                params, target_params,
                torch.ones((), dtype=torch.bool, device=device))
        if t % cfg.eval_freq == 0:
            eval_next = True
        if t % cfg.save_freq == 0:
            save_next = True
        if t % cfg.log_freq == 0:
            if logger is not None:
                logger.log_value("loss", loss_val, step=t)
                logger.log_value("grad_val", grad_val, step=t)
                logger.log_value("eval_reward", scores_eval, step=t)
            if cfg.verbose:
                print(f"{t:5d} / {cfg.max_steps:5d} | Loss {loss_val:2.3e} | "
                      f"Grad {grad_val:2.3e} | EvalR {scores_eval:1.3f}")

    if logger is not None:
        logger.close()
    if model_saved and solver.logdir is not None:
        if cfg.verbose:
            print(f"Restore model with eval reward {saved_mean_reward:1.3f}")
        policy.params = checkpoint.load_params(solver.logdir, params)
    return policy


def _make_host_buffer(solver, obs_shape, device):
    from ..replay.episode import EpisodeReplayBuffer
    from ..replay.prioritized import PrioritizedReplayBuffer

    cfg = solver.config
    if cfg.recurrence:
        return EpisodeReplayBuffer(
            obs_shape, cfg.buffer_size, cfg.batch_size, cfg.trace_length,
            cfg.max_episode_length, num_envs=1, device=device)
    return PrioritizedReplayBuffer(
        obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon,
        prioritized=cfg.prioritized_replay, device=device)
