"""The JAX package's feed-forward learning tests (``tests/test_learning.py``
vanilla, double-Q, dueling, prioritized and vectorized) on the port, on the
CPU: the same configs and thresholds, and a greedy evaluation of 100
episodes from a generator seeded 7, as the JAX tests evaluate with
``PRNGKey(7)``. TestMDP's optimum is 2.1, the threshold 1.5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch import (  # noqa: E402
    Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
    LinearDecaySchedule, TestMDP, basic_evaluation)


def evaluate(env, policy, seed=7, n_ep=100, max_steps=100):
    r, _, _ = basic_evaluation(policy.network, policy.params, env, n_ep,
                               max_steps, seed)
    return r


def solver(model, max_steps=10000, **kw):
    defaults = dict(
        qnetwork=model, max_steps=max_steps, learning_rate=0.005,
        eval_freq=2000, num_ep_eval=100, log_freq=2000, logdir=None,
        verbose=False, device="cpu",
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, max_steps // 2)))
    defaults.update(kw)
    return DeepQLearningSolver(**defaults)


def mlp(mdp):
    return Chain(Flatten(), Dense(100, 8, torch.tanh),
                 Dense(8, mdp.num_actions))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vanilla_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    policy = solver(mlp(mdp), double_q=False, dueling=False,
                    prioritized_replay=False).solve(mdp)
    assert evaluate(mdp, policy) >= 1.5
    av = policy.actionvalues(np.zeros((5, 5, 4), np.float32))
    assert av.shape == (mdp.num_actions,)


def test_double_q_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    policy = solver(mlp(mdp), double_q=True, dueling=False,
                    prioritized_replay=False).solve(mdp)
    assert evaluate(mdp, policy) >= 1.5


def test_dueling_dqn():
    mdp = TestMDP((5, 5), 4, 6)
    policy = solver(mlp(mdp), double_q=False, dueling=True,
                    prioritized_replay=False).solve(mdp)
    assert evaluate(mdp, policy) >= 1.5


def test_prioritized_ddqn():
    mdp = TestMDP((5, 5), 4, 6)
    policy = solver(mlp(mdp), double_q=True, dueling=True,
                    prioritized_replay=True).solve(mdp)
    assert evaluate(mdp, policy) >= 1.5


def test_vectorized_envs_learning():
    mdp = TestMDP((5, 5), 4, 6)
    policy = solver(mlp(mdp), double_q=True, dueling=True,
                    prioritized_replay=True, num_envs=8, train_freq=8,
                    max_steps=16000, buffer_size=4096).solve(mdp)
    assert evaluate(mdp, policy) >= 1.5
