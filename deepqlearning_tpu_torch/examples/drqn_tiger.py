"""Recurrent DRQN on the Tiger POMDP: an LSTM Q-network over episode
replay (``examples/drqn_tiger.py``). The agent must listen (partial
observability) before opening a door; the LSTM carries belief across
steps."""
import numpy as np

from deepqlearning_tpu_torch import (
    LSTM, Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
    LinearDecaySchedule, TigerPOMDP)


def config(**overrides) -> dict:
    cfg = dict(
        max_steps=10000, learning_rate=1e-3, recurrence=True,
        trace_length=10, double_q=True, dueling=True,
        prioritized_replay=False, target_update_freq=1000, log_freq=500,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, 5000)))
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides):
    pomdp = TigerPOMDP()
    model = Chain(Flatten(), LSTM(1, 8), Dense(8, pomdp.num_actions))
    solver = DeepQLearningSolver(qnetwork=model, device=device,
                                 **config(**overrides))
    policy = solver.solve(pomdp)
    policy.reset_state()
    print("Q after no observation:",
          policy.actionvalues(np.zeros(1, np.float32)))
    return solver, policy


if __name__ == "__main__":
    main()
