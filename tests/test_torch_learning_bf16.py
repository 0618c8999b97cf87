"""The JAX package's bf16 learning tests (``tests/test_learning.py::
test_bf16_replay_storage`` and ``::test_bf16_dtype_reaches_params_and_
solves``) on the port, on the CPU: the same configurations and thresholds
and a greedy evaluation of 100 episodes from a generator seeded 7, as the
JAX test evaluates with ``PRNGKey(7)`` (TestMDP's optimum is 2.1; the bf16
threshold 1.0). Then a small bf16 conv solve (the image path of
``examples/image_conv_dqn.py`` at narrow widths) that ends finite with bf16
leaves and resumes from its checkpoint."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch import (  # noqa: E402
    Activation, Chain, Conv2D, DeepQLearningSolver, Dense, EpsGreedyPolicy,
    Flatten, LinearDecaySchedule, SimpleGridWorld, TestMDP)
from deepqlearning_tpu_torch.solver import checkpoint  # noqa: E402
from test_torch_learning_ff import evaluate, mlp, solver  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_replay_storage():
    mdp = TestMDP((5, 5), 4, 6)
    s = solver(mlp(mdp), max_steps=4000, double_q=True, dueling=False,
               prioritized_replay=True, dtype=torch.bfloat16)
    policy = s.solve(mdp)
    assert {p.dtype for p in policy.params.values()} == {torch.bfloat16}
    assert evaluate(mdp, policy) >= 1.0


def test_bf16_dtype_reaches_params_and_solves():
    env = SimpleGridWorld()
    s = DeepQLearningSolver(
        qnetwork=Chain(Dense(2, 16, torch.tanh), Dense(16, env.num_actions)),
        max_steps=512, num_envs=16, train_freq=16, buffer_size=1024,
        train_start=128, eval_freq=512, log_freq=512, save_freq=1 << 30,
        double_q=True, dueling=False, prioritized_replay=True,
        verbose=False, logdir=None, max_episode_length=50,
        dtype=torch.bfloat16, device="cpu",
        exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(1.0, 0.1, 256)))
    policy = s.solve(env)
    leaf = next(iter(policy.params.values()))
    assert leaf.dtype == torch.bfloat16
    assert policy.action(np.asarray([1.0, 1.0], np.float32)) in env.action_map


def test_small_bf16_conv_solve_resumes(tmp_path):
    """A dueling bf16 conv net on TestMDP's (6, 6, 4) image obs: 16 envs,
    U = 2 grouped updates of 16, evaluations, a saved model and the train
    state; the solve ends finite with bf16 leaves (moments and replay rows
    too), ``restore_best_model`` loads the saved bf16 weights, and
    ``resume=True`` continues from the saved counters."""
    mdp = TestMDP((6, 6), 4, 6)
    relu = torch.relu
    model = Chain(
        Activation(lambda x: x.to(torch.bfloat16)),
        Conv2D(4, 8, (3, 3), (1, 1), "SAME", relu),
        Conv2D(8, 8, (3, 3), (2, 2), "SAME", relu), Flatten(),
        Dense(3 * 3 * 8, 16, relu), Dense(16, mdp.num_actions))

    def run(resume):
        s = DeepQLearningSolver(
            qnetwork=model, max_steps=320, num_envs=16, train_freq=8,
            batch_size=16, buffer_size=512, train_start=64,
            learning_rate=1e-3, max_episode_length=6, double_q=True,
            dueling=True, prioritized_replay=True, target_update_freq=64,
            eval_freq=160, num_ep_eval=16, log_freq=160, save_freq=160,
            logdir=str(tmp_path), verbose=False, dtype="bfloat16",
            device="cpu",
            exploration_policy=EpsGreedyPolicy(
                LinearDecaySchedule(1.0, 0.1, 160)))
        return s, s.solve(mdp, resume=resume)

    s, p1 = run(False)
    assert s.config.updates_per_iter == 2
    assert all(p.dtype == torch.bfloat16 and torch.isfinite(p).all()
               for p in p1.params.values())
    assert all(np.isfinite(r) for _, r in s.metrics["eval"])
    saved = torch.load(str(tmp_path / checkpoint.TRAIN_STATE_NAME),
                       weights_only=True)["__fields__"]
    assert saved["replay"]["__fields__"]["rows"].dtype == torch.bfloat16
    assert {m.dtype for m in saved["opt_state"]["__fields__"]["m"].values()
            } == {torch.bfloat16}
    iters = saved["iters"]
    best = s.restore_best_model(mdp)
    assert {p.dtype for p in best.params.values()} == {torch.bfloat16}
    assert best.action(np.zeros((6, 6, 4), np.float32)) in mdp.action_map
    s2, p2 = run(True)
    again = torch.load(str(tmp_path / checkpoint.TRAIN_STATE_NAME),
                       weights_only=True)["__fields__"]
    assert again["iters"] == 2 * iters
    assert int(again["opt_state"]["__fields__"]["count"]) == 2 * int(
        saved["opt_state"]["__fields__"]["count"])
    assert all(p.dtype == torch.bfloat16 and torch.isfinite(p).all()
               for p in p2.params.values())
