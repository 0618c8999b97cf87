"""Evaluation strategies (``deepqlearning_tpu.solver.evaluation``).

``basic_evaluation`` runs ``n_eval`` greedy episodes in lockstep, in plain
torch on the parameters' device, and returns the mean undiscounted return
and the mean episode length. A pluggable strategy has the signature
``f(network, params, env, n_eval, max_episode_length, generator, verbose)
-> (avg_r, avg_steps, info)``, with a ``torch.Generator`` where the JAX
package passes a key.
"""
from __future__ import annotations

import torch


def _generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a generator on ``device`` seeded with the
    int ``generator``."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


@torch.no_grad()
def _eval_rollout(env, params, network, n_eval, max_episode_length,
                  generator):
    device = next(iter(params.values())).device
    env_state, obs = env.reset_batch(n_eval, generator)
    net_state = network.init_state(n_eval, device)
    finished = torch.zeros(n_eval, dtype=torch.bool, device=device)
    ret = torch.zeros(n_eval, dtype=torch.float32, device=device)
    steps = torch.zeros_like(ret)
    for _ in range(max_episode_length + 1):
        q, net_state = network.apply(params, obs, net_state)
        action = torch.argmax(q, dim=-1)
        env_state, obs, r, done = env.step_batch(env_state, action,
                                                 generator)
        active = (~finished).float()
        ret = ret + r * active
        steps = steps + active
        finished = finished | (done > 0.5)
    # the mean as XLA computes it: the f32 sum times the f32 reciprocal
    inv = 1.0 / n_eval
    return ret.sum() * inv, steps.sum() * inv


def basic_evaluation(network, params, env, n_eval, max_episode_length,
                     generator, verbose=False):
    """Greedy lockstep rollouts over ``max_episode_length + 1`` steps; an
    episode stops counting once it is done. ``generator`` (a
    ``torch.Generator`` or an int seed) draws the resets and the env steps.
    Returns ``(avg_r, avg_steps, {})``."""
    device = next(iter(params.values())).device
    avg_r, avg_steps = _eval_rollout(
        env, params, network, int(n_eval), int(max_episode_length),
        _generator(generator, device))
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
