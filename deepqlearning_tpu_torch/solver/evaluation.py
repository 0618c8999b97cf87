"""Evaluation strategies (``deepqlearning_tpu.solver.evaluation``).

``basic_evaluation`` runs ``n_eval`` greedy episodes in lockstep over
``max_episode_length + 1`` steps, on the parameters' device, and returns
the mean undiscounted return and the mean episode length. A pluggable
strategy has the signature ``f(network, params, env, n_eval,
max_episode_length, generator, verbose) -> (avg_r, avg_steps, info)``,
with a ``torch.Generator`` where the JAX package passes a key.

The JAX package jits the rollout as one ``lax.scan`` over the steps. Its
counterpart on the card, for parameters and a generator on a CUDA device
and an env of the ``Env`` protocol, is two CUDA graphs
(``learner/segment.py::CompiledSegment``): the reset, replayed once, and
one greedy step, replayed ``max_episode_length + 1`` times, over a static
carry ``(env_state, obs, net_state, finished, ret, steps, generator)``.
The graphs are captured at the first call for a ``(network, env, n_eval,
device, parameter shapes and dtypes)`` and kept, as ``jax.jit`` keeps its
programs; ``max_episode_length`` only sets the count of replays. Each
call copies the caller's parameters into the graphs' own, sets their
generator from the caller's and, after the replays, writes its state back,
so the result and the caller's generator are those of the eager rollout,
bit for bit. The env's and the network's code inside the rollout must be
pure device code, as in a compiled segment: a capture that fails, or a
guard replay that differs from the eager step (a Python counter in the
env), raises. Elsewhere (CPU tensors, a CPU generator, an env outside the
protocol) the rollout runs eagerly; a user's own strategy runs as written.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map

from ..envs.base import Env


class EvalCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor
    net_state: Any
    finished: torch.Tensor
    ret: torch.Tensor
    steps: torch.Tensor
    generator: torch.Generator


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a generator on ``device`` seeded with the
    int ``generator``."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def eval_reset(env, network, n_eval: int, device, generator) -> EvalCarry:
    """The rollout's start: ``n_eval`` envs reset from ``generator``."""
    env_state, obs = env.reset_batch(n_eval, generator)
    ret = torch.zeros(n_eval, dtype=torch.float32, device=device)
    return EvalCarry(env_state, obs, network.init_state(n_eval, device),
                     torch.zeros(n_eval, dtype=torch.bool, device=device),
                     ret, torch.zeros_like(ret), generator)


def eval_step(env, network, params):
    """One greedy lockstep step of the rollout, ``EvalCarry -> EvalCarry``;
    an episode stops counting once it is done."""

    def step(c: EvalCarry) -> EvalCarry:
        q, net_state = network.apply(params, c.obs, c.net_state)
        if not tree_flatten(net_state)[0] and not tree_flatten(
                c.net_state)[0]:
            # a feed-forward network's state holds nothing, but its
            # nesting may differ from init_state's: keep the carry's
            net_state = c.net_state
        action = torch.argmax(q, dim=-1)
        env_state, obs, r, done = env.step_batch(c.env_state, action,
                                                 c.generator)
        active = (~c.finished).float()
        return EvalCarry(env_state, obs, net_state,
                         c.finished | (done > 0.5), c.ret + r * active,
                         c.steps + active, c.generator)

    return step


def _means(c: EvalCarry, n_eval: int):
    # the mean as XLA computes it: the f32 sum times the f32 reciprocal
    inv = 1.0 / n_eval
    return c.ret.sum() * inv, c.steps.sum() * inv


@torch.no_grad()
def _eval_rollout(env, params, network, n_eval, max_episode_length,
                  generator):
    device = next(iter(params.values())).device
    c = eval_reset(env, network, n_eval, device, generator)
    step = eval_step(env, network, params)
    for _ in range(max_episode_length + 1):
        c = step(c)
    return _means(c, n_eval)


class EvalGraph:
    """The rollout's reset and greedy step captured as CUDA graphs over one
    static :class:`EvalCarry`, with their own copy of the parameters and
    their own generator (module docstring)."""

    @torch.no_grad()
    def __init__(self, env, network, params, n_eval: int, device):
        from ..learner.segment import CompiledSegment

        self.env, self.network, self.n_eval = env, network, n_eval
        self.params = {k: p.clone() for k, p in params.items()}
        # static buffers of their own (a reset may return the state and a
        # view of it as the obs)
        self.carry = tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x,
            eval_reset(env, network, n_eval, device,
                       torch.Generator(device=device)))
        name = type(env).__name__
        self.reset = CompiledSegment(
            lambda c: eval_reset(env, network, n_eval, device, c.generator),
            self.carry, f"basic_evaluation reset ({name})")
        self.step = CompiledSegment(eval_step(env, network, self.params),
                                    self.carry,
                                    f"basic_evaluation step ({name})")

    @torch.no_grad()
    def __call__(self, params, max_episode_length: int, generator):
        torch._foreach_copy_(list(self.params.values()),
                             [params[k] for k in self.params])
        g = self.carry.generator
        g.set_state(generator.get_state())
        self.reset(self.carry, 1)
        self.step(self.carry, max_episode_length + 1)
        generator.set_state(g.get_state())
        return _means(self.carry, self.n_eval)


# the captured rollouts, the counterpart of jax.jit's cache of compiled
# programs: by (network, env, n_eval, device, parameter shapes and dtypes),
# the most recently used first out of the last CACHED
_GRAPHS: "OrderedDict[tuple, EvalGraph]" = OrderedDict()
CACHED = 8


def eval_graph(network, params, env, n_eval: int, device) -> EvalGraph:
    """The :class:`EvalGraph` of this rollout, captured at its first use."""
    key = (id(network), id(env), n_eval, str(device),
           tuple((k, tuple(p.shape), p.dtype) for k, p in params.items()))
    graph = _GRAPHS.get(key)
    if graph is None or graph.network is not network or graph.env is not env:
        graph = _GRAPHS[key] = EvalGraph(env, network, params, n_eval, device)
        while len(_GRAPHS) > CACHED:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return graph


def graphed(params, env, generator) -> bool:
    """The static gate of the evaluation graph: parameters and generator
    on a CUDA device, and an env of the ``Env`` protocol."""
    device = next(iter(params.values())).device
    return (device.type == "cuda" and generator.device.type == "cuda"
            and isinstance(env, Env))


def basic_evaluation(network, params, env, n_eval, max_episode_length,
                     generator, verbose=False):
    """Greedy lockstep rollouts over ``max_episode_length + 1`` steps; an
    episode stops counting once it is done. ``generator`` (a
    ``torch.Generator`` or an int seed) draws the resets and the env steps;
    as graph replays on the card (module docstring). Returns ``(avg_r,
    avg_steps, {})``."""
    device = next(iter(params.values())).device
    n_eval, max_episode_length = int(n_eval), int(max_episode_length)
    generator = _generator(generator, device)
    if graphed(params, env, generator):
        avg_r, avg_steps = eval_graph(network, params, env, n_eval, device)(
            params, max_episode_length, generator)
    else:
        avg_r, avg_steps = _eval_rollout(env, params, network, n_eval,
                                         max_episode_length, generator)
    avg_r, avg_steps = float(avg_r), float(avg_steps)
    if verbose:
        print(f"Evaluation ... Avg Reward {avg_r:2.2f} | Avg Step "
              f"{avg_steps:2.2f}")
    return avg_r, avg_steps, {}


def evaluation(f, network, params, env, n_eval, max_episode_length,
               generator, verbose=False):
    """Dispatch through a user-provided strategy."""
    return f(network, params, env, n_eval, max_episode_length, generator,
             verbose)
