"""DeepQLearningSolver, the training orchestrator
(``deepqlearning_tpu.solver.solver``).

``solve(env)`` turns a problem into a trained ``NNPolicy``: a ``HostEnv``
goes to the serial host loop (``envs/compat.py::solve_host``), a raw
MDP/POMDP problem object (either form: one instance at a time or batched)
is wrapped by ``envs/adapters.py``, and an ``Env`` (either form) runs
``learner/loop.py::build_loop``: the replay is pre-filled with
ε = 1 collect steps, then the iterations run in segments between the log,
eval and save boundaries, with the JAX package's deferred eval and
best-model saves, and at the end the train state is saved and the best
model restored. The segment arithmetic (``crossed``, ``seg_iters``,
``total_iters``), the ``metrics`` keys, the verbose line and the
TensorBoard tags are the JAX package's.

What differs from the JAX package:

* ``device``: the solver trains on ``device``; ``None`` is the card
  (``device.py::resolve_device``), which raises without CUDA. The network is
  copied there, so the caller's module is left as it was.
* Randomness: one seeded ``torch.Generator`` per role (init, populate,
  actor, eval, learn) on the device, seeded from ``numpy.random.
  SeedSequence(seed)``, where the JAX package splits one key five ways. The
  streams differ from JAX's (the TPU PRNG stream, ``docs/DEVIATIONS.md``
  item 15); the same seed gives the same policy.
* The stock ``EpsGreedyPolicy`` reaches ``build_loop`` as its schedule
  alone (``select_fn=None``), so the collect kernels K4/K6 take it wherever
  ``collect_plan_for`` accepts the env and network; the JAX solver always
  passed its ``select`` and so never reached its fused collect. Only a
  ``VectorizedStrategy`` or another custom ``select`` is passed as
  ``select_fn``.
* Checkpoints are ``torch.save`` archives (``solver/checkpoint.py``),
  which keep each tensor's dtype.
* The JAX solver jits ``populate`` and each segment (``lax.scan`` over
  the iteration); here the routes of ``learner/segment.py::graph_route``
  (feed-forward, PER, the env's own batched methods, f32 or bf16) run
  them as replays of one CUDA graph per step on the card, and the others
  (DRQN, per-instance envs) enqueue every op from Python. A graph that
  cannot be captured, or whose replay differs from the eager iteration
  (host-side state in user code), raises; there is no switch back to
  eager.
* ``cfg.dtype`` (e.g. ``torch.bfloat16``) reaches the parameters and the
  replay storage, as in the JAX package; the policy and the evaluation
  feed the env's f32 observations to the network, which promotes them.
"""
from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from ..config import DQNConfig
from ..device import counter, resolve_device
from ..envs.base import Env
from ..learner.actor import avg_recent, init_actor
from ..learner.loop import LoopCarry, build_loop
from ..learner.segment import make_collect_graph, make_segment
from ..models.chain import isrecurrent
from ..models.dueling import create_dueling_network
from ..replay.episode import EpisodeReplayBuffer
from ..replay.prioritized import PrioritizedReplayBuffer
from . import checkpoint
from .evaluation import basic_evaluation, evaluation
from .exploration import EpsGreedyPolicy, LinearDecaySchedule, eps_schedule
from .policy import NNPolicy

ROLES = ("init", "populate", "actor", "eval", "learn")


def role_generators(seed: int, device) -> dict:
    """One ``torch.Generator`` on ``device`` per role of :data:`ROLES`,
    seeded from ``numpy.random.SeedSequence(seed)``."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(len(ROLES))
    return {role: torch.Generator(device=device).manual_seed(int(s))
            for role, s in zip(ROLES, seeds)}


def _stock_eps_greedy(ep) -> bool:
    return (isinstance(ep, EpsGreedyPolicy)
            and type(ep).select is EpsGreedyPolicy.select)


class DeepQLearningSolver:
    """Config + strategy container; ``solve(env)`` returns an ``NNPolicy``.

    ``qnetwork`` is a ``Chain`` (or ``DuelingNetwork``);
    ``exploration_policy`` an ``EpsGreedyPolicy``, a schedule, a
    ``VectorizedStrategy`` or (host path only) a function ``f(policy, env,
    obs, t, rng) -> (action, eps)``; ``evaluation_policy`` has the signature
    of ``basic_evaluation``; ``device`` as in the module docstring."""

    def __init__(self, qnetwork=None, exploration_policy=None,
                 evaluation_policy=basic_evaluation, device=None,
                 **config_kwargs):
        self.config = DQNConfig(**config_kwargs)
        self.qnetwork = qnetwork
        if exploration_policy is None:
            exploration_policy = EpsGreedyPolicy(LinearDecaySchedule(
                1.0, 0.01, max(1, self.config.max_steps // 2)))
        self.exploration_policy = exploration_policy
        self.evaluation_policy = evaluation_policy
        self.device = device
        self.logdir = self.config.logdir
        self.metrics: dict = {"t": [], "loss": [], "grad": [], "avg100": [],
                              "eval": []}

    # ------------------------------------------------------------------
    def _build_network(self, device):
        """A copy of ``qnetwork`` on ``device`` (dueling if configured)."""
        network = self.qnetwork
        if isrecurrent(network) and not self.config.recurrence:
            raise ValueError(
                "DeepQLearningError: you passed in a recurrent model but "
                "recurrence is set to false")
        network = copy.deepcopy(network)
        if self.config.dueling:
            network = create_dueling_network(network)
        return network.to(device)

    def _build_buffer(self, env: Env, device):
        cfg = self.config
        if cfg.recurrence:
            return EpisodeReplayBuffer(
                env.obs_shape, cfg.buffer_size, cfg.batch_size,
                cfg.trace_length, cfg.max_episode_length,
                num_envs=cfg.num_envs, obs_dtype=cfg.dtype, device=device)
        return PrioritizedReplayBuffer(
            env.obs_shape, cfg.buffer_size, cfg.batch_size,
            alpha=cfg.prioritized_replay_alpha,
            beta=cfg.prioritized_replay_beta,
            eps=cfg.prioritized_replay_epsilon,
            prioritized=cfg.prioritized_replay, obs_dtype=cfg.dtype,
            sample_mode=cfg.prioritized_sample_mode, device=device)

    def _strategy(self):
        """``(eps_fn, select_fn)`` for ``build_loop``."""
        ep = self.exploration_policy
        if _stock_eps_greedy(ep):
            return ep.eps, None
        select_fn = getattr(ep, "select", None)
        select_fn = select_fn if callable(select_fn) else None
        eps_fn = eps_schedule(ep)
        if eps_fn is None and select_fn is not None:
            eps_fn = lambda t: 0.0  # a custom strategy without ε logs 0
        elif eps_fn is None:
            raise TypeError(
                "the vectorized path needs a schedule-based exploration "
                "policy (EpsGreedyPolicy / LinearDecaySchedule / "
                "ConstantEpsilon) or a VectorizedStrategy with the "
                "select(q_values, t, generator) -> (actions, eps) protocol; "
                "bare function-valued strategies f(policy, env, obs, t, rng) "
                "are supported on the HostEnv path")
        return eps_fn, select_fn

    # ------------------------------------------------------------------
    def solve(self, env, resume: bool = False) -> NNPolicy:
        """Train and return the greedy policy. ``resume=True`` restores the
        full training state saved in ``logdir`` by an earlier solve and
        continues for another ``max_steps``."""
        from ..envs.compat import HostEnv, solve_host

        if isinstance(env, HostEnv):
            return solve_host(self, env)
        if not isinstance(env, Env):
            from ..envs.adapters import MDPEnv, POMDPEnv, check_requirements

            if callable(getattr(env, "observation", None)) and callable(
                    getattr(env, "convert_o", None)):
                check_requirements(env, pomdp=True)
                env = POMDPEnv(env)
            elif callable(getattr(env, "initial_state", None)) and callable(
                    getattr(env, "gen", None)):
                check_requirements(env, pomdp=False)
                env = MDPEnv(env)
            else:
                raise TypeError(
                    "solve expects an Env, a HostEnv, or a "
                    "FunctionalMDP/POMDP problem object; got "
                    f"{type(env).__name__}")
        return self._solve_functional(env, resume=resume)

    # ------------------------------------------------------------------
    def _solve_functional(self, env: Env, resume: bool = False) -> NNPolicy:
        cfg = self.config
        device = resolve_device(self.device)
        network = self._build_network(device)
        buffer = self._build_buffer(env, device)
        gamma = float(env.discount)
        gens = role_generators(cfg.seed, device)
        # cfg.dtype reaches the parameters here and the replay storage in
        # _build_buffer
        params = network.init(gens["init"], cfg.dtype)

        eps_fn, select_fn = self._strategy()
        iteration, populate_step, optimizer = build_loop(
            env, network, buffer, cfg, eps_fn, gamma, select_fn=select_fn)

        # pre-fill the replay with a random policy
        zero = torch.zeros((), dtype=torch.float32, device=device)
        carry = LoopCarry(
            init_actor(env, network, cfg.num_envs, gens["populate"], device),
            buffer.init(), params, {k: p.clone() for k, p in params.items()},
            optimizer.init(params), gens["populate"], zero, zero.clone(),
            counter(0, device), counter(0, device))
        n_pop = -(-cfg.train_start // cfg.num_envs)
        if cfg.recurrence:
            # every env commits an episode before the first sample
            n_pop = max(n_pop, cfg.max_episode_length + 1)
        # the routes of learner/segment.py::graph_route run populate and
        # every segment as replays of one CUDA graph on the card, the
        # others eagerly
        route = (f"solve on {type(env).__name__} "
                 f"(U={cfg.updates_per_iter}, {cfg.dtype})")
        carry = make_collect_graph(populate_step, carry, cfg, env, buffer,
                                   f"{route}, populate")(carry, n_pop)
        carry = carry._replace(
            actor=init_actor(env, network, cfg.num_envs, gens["actor"],
                             device),
            generator=gens["learn"])
        if resume:
            carry = checkpoint.load_train_state(self.logdir, carry)
        run_segment = make_segment(iteration, carry, cfg, env, buffer, route)

        spi = cfg.env_steps_per_iter
        seg_env_steps = max(spi, min(cfg.log_freq, cfg.eval_freq,
                                     cfg.save_freq))
        seg_iters = max(1, seg_env_steps // spi)
        total_iters = max(1, -(-cfg.max_steps // spi))

        logger = None
        if self.logdir is not None:
            from ..utils.tb_writer import TBWriter

            logger = TBWriter(self.logdir)
            self.logdir = logger.logdir

        saved_mean_reward = -math.inf
        scores_eval = -math.inf
        model_saved = eval_next = save_next = False

        def crossed(freq, t0, t1):
            return t1 // freq > t0 // freq

        done_iters = 0
        while done_iters < total_iters:
            n = min(seg_iters, total_iters - done_iters)
            seg_t0 = time.perf_counter()
            carry = run_segment(carry, n)
            loss_val = float(carry.loss)  # waits for the segment's work
            seg_s = time.perf_counter() - seg_t0
            done_iters += n
            t0 = (done_iters - n) * spi
            t1 = done_iters * spi

            if crossed(cfg.eval_freq, t0, t1):
                eval_next = True
            if crossed(cfg.save_freq, t0, t1):
                save_next = True

            if eval_next:
                scores_eval, steps_eval, info_eval = evaluation(
                    self.evaluation_policy, network, carry.params, env,
                    cfg.num_ep_eval, cfg.max_episode_length, gens["eval"],
                    cfg.verbose)
                eval_next = False
                if save_next:
                    model_saved, saved_mean_reward = checkpoint.save_model(
                        self.logdir, carry.params, scores_eval,
                        saved_mean_reward, model_saved, cfg.verbose)
                    save_next = False
                if logger is not None:
                    logger.log_value("eval_reward", scores_eval, step=t1)
                    logger.log_value("eval_steps", steps_eval, step=t1)
                    for mk, mv in info_eval.items():
                        logger.log_value(mk, mv, step=t1)
                self.metrics["eval"].append((t1, scores_eval))

            if crossed(cfg.log_freq, t0, t1):
                sps = (n * spi / seg_s) if seg_s else 0.0
                grad_val = float(carry.gnorm)
                avg100 = float(avg_recent(carry.actor.ret_ring,
                                          carry.actor.cnt_ring))
                eps_val = float(eps_fn(t1))
                self.metrics["t"].append(t1)
                self.metrics["loss"].append(loss_val)
                self.metrics["grad"].append(grad_val)
                self.metrics["avg100"].append(avg100)
                if logger is not None:
                    logger.log_value("eps", eps_val, step=t1)
                    logger.log_value("avg_reward", avg100, step=t1)
                    logger.log_value("loss", loss_val, step=t1)
                    logger.log_value("grad_val", grad_val, step=t1)
                    logger.log_value("env_steps_per_s", sps, step=t1)
                if cfg.verbose:
                    print(
                        f"{t1:5d} / {cfg.max_steps:5d} eps {eps_val:0.3f} | "
                        f"avgR {avg100:1.3f} | Loss {loss_val:2.3e} | "
                        f"Grad {grad_val:2.3e} | EvalR {scores_eval:1.3f} | "
                        f"{sps:,.0f} steps/s")

        if self.logdir is not None:
            checkpoint.save_train_state(self.logdir, carry)
        if logger is not None:
            logger.close()

        params = carry.params
        if model_saved and self.logdir is not None:
            if cfg.verbose:
                print(f"Restore model with eval reward "
                      f"{saved_mean_reward:1.3f}")
            params = checkpoint.load_params(self.logdir, params)
        return NNPolicy(env, network, params, env.action_map,
                        len(env.obs_shape))

    # ------------------------------------------------------------------
    def restore_best_model(self, env) -> NNPolicy:
        """Rebuild the policy and load the best saved weights."""
        device = resolve_device(self.device)
        network = self._build_network(device)
        params = network.init(role_generators(self.config.seed,
                                              device)["init"],
                              self.config.dtype)
        params = checkpoint.load_params(self.logdir, params)
        return NNPolicy(env, network, params, env.action_map,
                        len(env.obs_shape))


def solve(solver: DeepQLearningSolver, env) -> NNPolicy:
    """Functional entry point: ``solver.solve(env)``."""
    return solver.solve(env)


def restore_best_model(solver: DeepQLearningSolver, env) -> NNPolicy:
    return solver.restore_best_model(env)
