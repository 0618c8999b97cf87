"""The compiled segment's guard against host state, on the card
(``deepqlearning_tpu_torch/learner/segment.py``).

A CUDA graph replays what the capture recorded, so a user env that keeps a
Python counter would repeat the counter's value at capture on every replay.
``make_segment`` runs one replay after the capture and raises where it
differs from the eager warm-up iteration; the same env without the counter
is captured. These tests need an NVIDIA GPU (a CUDA graph has no CPU form)
and skip elsewhere. On a card::

    python -m pytest --noconftest -m card tests/test_torch_segment_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch import (  # noqa: E402
    Chain, Dense, DQNConfig, LinearDecaySchedule, PrioritizedReplayBuffer)
from deepqlearning_tpu_torch.envs.base import Env  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry, populate)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    CompiledSegment, make_segment)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    return torch.device("cuda:0")


class Drift(Env):
    """A user env written batched on ``[0, 1]``; with ``host_counter`` the
    step grows with a Python count of the env's steps."""

    num_actions, obs_shape, discount = 2, (1,), 0.9

    def __init__(self, host_counter):
        self.host_counter = host_counter
        self.steps = 0

    def reset_batch(self, num, generator):
        s = torch.rand(num, generator=generator, device=generator.device)
        return s, s[:, None]

    def observe_batch(self, state):
        return state[:, None]

    def step_batch(self, state, action, generator):
        self.steps += 1
        d = 0.01 * (self.steps if self.host_counter else 1)
        s = (state + torch.where(action == 1, d, -d)).clamp(0.0, 1.0)
        return s, s[:, None], s, (s >= 1.0).float()


def _segment(dev, host_counter):
    env = Drift(host_counter)
    net = Chain(Dense(1, 16, torch.tanh, device=dev), Dense(16, 2, device=dev))
    cfg = DQNConfig(num_envs=256, batch_size=32, buffer_size=1 << 12,
                    train_freq=256, max_episode_length=20, double_q=True,
                    prioritized_replay=True)
    buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 10_000),
                              env.discount)
    c = it(populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev), 2))
    return make_segment(it, c, cfg, env, buf, "Drift"), c


@pytest.mark.card
def test_pure_device_env_is_captured(card):
    run, c = _segment(card, host_counter=False)
    assert isinstance(run, CompiledSegment)
    c = run(c, 3)
    assert int(c.iters) == 4 and bool(torch.isfinite(c.loss))


@pytest.mark.card
def test_host_counter_in_env_raises(card):
    with pytest.raises(RuntimeError, match="differs from the eager iteration"):
        _segment(card, host_counter=True)
