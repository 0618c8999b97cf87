"""CartPole with 256 lockstep envs, a classic-control sanity run
(``examples/cartpole_dqn.py``)."""
import torch

from deepqlearning_tpu_torch import (
    CartPole, Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy,
    LinearDecaySchedule)


def config(**overrides) -> dict:
    cfg = dict(
        max_steps=400_000, num_envs=256,
        # train_freq is measured in aggregate env steps: one batch-256
        # update per 16 transitions keeps a reference-like data/update ratio
        train_freq=16, batch_size=256, buffer_size=1 << 16,
        learning_rate=1e-3, target_update_freq=2_000, eval_freq=100_000,
        log_freq=50_000, num_ep_eval=64, max_episode_length=200,
        double_q=True, dueling=True, prioritized_replay=True,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.05, 150_000)))
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides):
    env = CartPole()
    model = Chain(Dense(4, 64, torch.tanh), Dense(64, 64, torch.tanh),
                  Dense(64, env.num_actions))
    solver = DeepQLearningSolver(qnetwork=model, device=device,
                                 **config(**overrides))
    policy = solver.solve(env)
    print("eval curve:", solver.metrics["eval"])
    return solver, policy


if __name__ == "__main__":
    main()
