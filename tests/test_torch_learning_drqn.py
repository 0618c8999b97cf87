"""The JAX package's recurrent learning tests (``tests/test_learning.py``
DRQN on TestMDP, double dueling DRQN on SimpleGridWorld, the Tiger smoke
test and the multi-env populate regression) on the port, on the CPU: the
same configs and thresholds, and greedy evaluations from a generator seeded
7, as the JAX tests evaluate with ``PRNGKey(7)``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch import (  # noqa: E402
    LSTM, Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
    LinearDecaySchedule, SimpleGridWorld, TestMDP, TigerPOMDP,
    basic_evaluation)


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


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_testmdp_drqn():
    mdp = TestMDP((5, 5), 1, 6)  # stack 1: partially observable
    model = Chain(Flatten(), LSTM(25, 8), Dense(8, mdp.num_actions))
    policy = solver(model, max_steps=6000, double_q=True, dueling=False,
                    recurrence=True, trace_length=10).solve(mdp)
    assert evaluate(mdp, policy) >= 0.0


def test_gridworld_ddrqn():
    mdp = SimpleGridWorld()
    model = Chain(Flatten(), LSTM(2, 32), Dense(32, mdp.num_actions))
    policy = solver(model, max_steps=6000, learning_rate=0.001,
                    prioritized_replay=False, recurrence=True,
                    trace_length=10, double_q=True,
                    dueling=True).solve(mdp)
    assert evaluate(mdp, policy, max_steps=10) >= 0.0


def test_tiger_ddrqn_smoke():
    pomdp = TigerPOMDP(discount=0.95)
    model = Chain(Flatten(), LSTM(1, 4), Dense(4, pomdp.num_actions))
    policy = solver(model, max_steps=2000, learning_rate=1e-4,
                    prioritized_replay=False, recurrence=True,
                    trace_length=10, double_q=True, dueling=True,
                    target_update_freq=1000).solve(pomdp)
    av = policy.actionvalues(np.zeros((1,), np.float32))
    assert av.shape == (pomdp.num_actions,)


def test_recurrent_populate_commits_episodes_multi_env():
    mdp = SimpleGridWorld()
    model = Chain(Flatten(), LSTM(2, 8), Dense(8, mdp.num_actions))
    policy = solver(model, max_steps=64, recurrence=True, trace_length=5,
                    num_envs=8, train_freq=8, prioritized_replay=False,
                    dueling=False, max_episode_length=20, buffer_size=64,
                    train_start=16, eval_freq=10_000).solve(mdp)
    assert policy.actionvalues(np.zeros(2, np.float32)).shape == (
        mdp.num_actions,)
