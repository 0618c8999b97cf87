"""Scaled collection: 4096 lockstep envs on one card
(``examples/scale_4096_envs.py``). The learning problem of
``gridworld_dqn``, with aggregate-step frequencies kept (``train_freq`` in
env steps); across ranks the same loop runs through
``parallel.DataParallelRunner``."""
from deepqlearning_tpu_torch import (
    Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, LinearDecaySchedule,
    SimpleGridWorld)


def config(**overrides) -> dict:
    cfg = dict(
        max_steps=2_000_000,  # aggregate env steps
        num_envs=4096,        # lockstep envs
        train_freq=4096,      # one update per sweep
        batch_size=512, buffer_size=1 << 17, eval_freq=500_000,
        log_freq=100_000, save_freq=1_000_000, learning_rate=1e-3,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, 1_000_000)))
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides):
    mdp = SimpleGridWorld()
    model = Chain(Dense(2, 64), Dense(64, mdp.num_actions))
    solver = DeepQLearningSolver(qnetwork=model, device=device,
                                 **config(**overrides))
    policy = solver.solve(mdp)
    print("done;", solver.metrics["eval"])
    return solver, policy


if __name__ == "__main__":
    main()
