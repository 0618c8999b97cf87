"""Image-observation DQN through a bf16 conv stack, the compute-bound path
(``examples/image_conv_dqn.py``).

TestMDP with (20, 20) stacked-frame image observations, solved with a
Conv2D Q-network in bf16: ``create_dueling_network`` splits the trailing
Dense stack into value and advantage heads (the solver does the split when
``dueling=True``); ``dtype=torch.bfloat16`` gives the parameters and the
replay storage bf16, and the first layer casts the observations to bf16;
2048 lockstep envs. On the card the convolutions run as cuDNN calls in
bf16 and the loss heads as kernel K1, the replay draw as K2.
"""
import torch

from deepqlearning_tpu_torch import (
    Activation, Chain, Conv2D, DeepQLearningSolver, Dense, EpsGreedyPolicy,
    Flatten, LinearDecaySchedule, TestMDP)


def model(num_actions: int) -> Chain:
    relu = torch.relu
    return Chain(
        Activation(lambda x: x.to(torch.bfloat16)),  # bf16 from the input on
        Conv2D(4, 32, (3, 3), (1, 1), "SAME", relu),
        Conv2D(32, 64, (3, 3), (2, 2), "SAME", relu),
        Conv2D(64, 128, (3, 3), (2, 2), "SAME", relu),
        Flatten(),
        Dense(5 * 5 * 128, 512, relu),
        Dense(512, num_actions),
    )


def config(max_steps: int = 400_000, **overrides) -> dict:
    cfg = dict(
        max_steps=max_steps, num_envs=2048, batch_size=512,
        buffer_size=1 << 15, train_freq=512, learning_rate=1e-3,
        max_episode_length=6, double_q=True, dueling=True,
        prioritized_replay=True, target_update_freq=512 * 64,
        eval_freq=max_steps // 8, num_ep_eval=128, log_freq=max_steps // 8,
        dtype=torch.bfloat16,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)))
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides):
    mdp = TestMDP((20, 20), 4, 6)  # obs (20, 20, 4): 4 stacked 20x20 frames
    solver = DeepQLearningSolver(qnetwork=model(mdp.num_actions),
                                 device=device, **config(**overrides))
    policy = solver.solve(mdp)
    finals = [r for _, r in solver.metrics["eval"]]
    print("eval returns:", [round(float(r), 2) for r in finals])
    print("best eval return:", round(max(finals), 2), "(optimum 2.1)")
    return solver, policy


if __name__ == "__main__":
    main()
