"""The reference README example: SimpleGridWorld, an MLP Q-network and
prioritized double dueling DQN for 10k steps (``examples/gridworld_dqn.py``).
"""
import numpy as np

from deepqlearning_tpu_torch import (
    Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, LinearDecaySchedule,
    SimpleGridWorld, basic_evaluation)


def config(**overrides) -> dict:
    cfg = dict(
        max_steps=10000,
        exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(
            start=1.0, stop=0.01, steps=10000 // 2)),
        learning_rate=0.005, log_freq=500, recurrence=False, double_q=True,
        dueling=True, prioritized_replay=True)
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides):
    mdp = SimpleGridWorld()
    model = Chain(Dense(2, 32), Dense(32, mdp.num_actions))
    solver = DeepQLearningSolver(qnetwork=model, device=device,
                                 **config(**overrides))
    policy = solver.solve(mdp)
    # deploy: a greedy rollout
    r, steps, _ = basic_evaluation(policy.network, policy.params, mdp, 1, 30,
                                   0)
    print(f"Total undiscounted reward for 1 simulation: {r}")
    print("action at (1,1):", policy.action(np.asarray([1.0, 1.0],
                                                       np.float32)))
    return solver, policy


if __name__ == "__main__":
    main()
