"""The port's entry points run on the card unless the caller asks for the
CPU (``deepqlearning_tpu_torch/device.py``): ``device=None`` is ``cuda``,
which raises without CUDA and never falls back to the CPU. Whether CUDA is
present is patched inside each test; nothing here allocates on a card."""
import types

import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.device import resolve_device  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry)

CPU_HINT = 'device="cpu"'


def _buffers(**kw):
    return {
        "PrioritizedReplayBuffer": lambda: dt.PrioritizedReplayBuffer(
            (2,), 64, 8, **kw),
        "ReplayBuffer": lambda: dt.ReplayBuffer((2,), 64, 8, **kw),
        "EpisodeReplayBuffer": lambda: dt.EpisodeReplayBuffer(
            (2,), 8, 4, 2, 4, num_envs=2, **kw),
    }


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _with_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("name", ["PrioritizedReplayBuffer", "ReplayBuffer",
                                  "EpisodeReplayBuffer"])
def test_buffer_without_device_raises_without_cuda(monkeypatch, name):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match=CPU_HINT):
        _buffers()[name]()
    # asking for the CPU still works
    assert _buffers(device="cpu")[name]().device == torch.device("cpu")


@pytest.mark.parametrize("name", ["PrioritizedReplayBuffer", "ReplayBuffer",
                                  "EpisodeReplayBuffer"])
def test_buffer_without_device_is_cuda(monkeypatch, name):
    # the constructors only record the device; their tensors come from init()
    _with_cuda(monkeypatch)
    assert _buffers()[name]().device == torch.device("cuda")


def test_resolve_device(monkeypatch):
    _with_cuda(monkeypatch)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match=CPU_HINT):
        resolve_device(None)
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def _setup(device):
    env = dt.SimpleGridWorld()
    net = dt.Chain(dt.Flatten(), dt.Dense(2, 8, torch.tanh), dt.Dense(8, 4))
    cfg = dt.DQNConfig(num_envs=16, batch_size=8, buffer_size=64,
                       train_freq=16)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, device=device)
    _, _, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(), 0.95)
    return env, net, buf, cfg, opt


def test_init_carry_without_device_raises_without_cuda(monkeypatch):
    env, net, _, cfg, opt = _setup("cpu")
    _no_cuda(monkeypatch)
    nowhere = types.SimpleNamespace(device=None)
    with pytest.raises(RuntimeError, match=CPU_HINT):
        init_carry(env, net, nowhere, cfg, opt)


def test_init_carry_takes_the_buffer_device():
    env, net, buf, cfg, opt = _setup("cpu")
    c = init_carry(env, net, buf, cfg, opt)
    assert c.loss.device == torch.device("cpu")
    assert c.replay.rows.device == torch.device("cpu")
    assert all(p.device == torch.device("cpu") for p in c.params.values())


def test_init_carry_refuses_params_on_another_device(monkeypatch):
    # a buffer recorded for the card, a network on the CPU: refused before
    # anything is allocated, naming both devices
    _with_cuda(monkeypatch)
    env, net, buf, cfg, opt = _setup(None)
    assert buf.device == torch.device("cuda")
    with pytest.raises(ValueError, match="cpu.*cuda"):
        init_carry(env, net, buf, cfg, opt)
    # explicit params are checked the same way
    env, net, cpu_buf, cfg, opt = _setup("cpu")
    with pytest.raises(ValueError, match="cpu.*cuda"):
        init_carry(env, net, cpu_buf, cfg, opt, device="cuda",
                   params={k: p.detach() for k, p in net.named_parameters()})
