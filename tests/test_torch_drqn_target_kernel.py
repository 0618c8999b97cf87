"""Kernel K11, the DRQN target net's Q(s') over every window of a step in
one launch (``deepqlearning_tpu_torch/ops/cuda/fused_drqn.py::
drqn_target_q``, ``csrc/fused_drqn.cu::dr_target_kernel``).

On the CPU: ``drqn_target_q`` takes its plain twin, the network's own
zero-state unroll, and gives the numbers of the code the fused recurrent
steps ran before K11 (``apply_sequence`` on ``init_state(N)`` over the
time-major windows, then back to batch-major) bit for bit, on every kind of
network the kernels' gate admits; the recorder counts the twin; the CUDA
entry refuses what K11 cannot take without touching the library; both
fused recurrent steps (K5's and the data-parallel K8's) call it once per
step.

On the card (marker ``card``; skipped without CUDA): K11 against its twin
within f32 sums in another order, at the ``grid_drqn.learner`` cell's shape
(dueling LSTM(2, 32), A = 4, 2048 windows of 8 steps) and on a GRU16 net
with an odd window count, a dueling GRU with two-layer heads and a 64-step
trace; two calls and ten replays of one captured CUDA graph bit for bit;
its counters. On a card::

    python -m pytest --noconftest -m card tests/test_torch_drqn_target_kernel.py
"""
import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_fused_dp_drqn_train_step, make_fused_grouped_drqn_train_step)
from deepqlearning_tpu_torch.ops.cuda import fused_drqn as fd  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda.kernel_events import (  # noqa: E402
    drqn_target_inputs, drqn_target_nets)
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)


def _more_nets():
    """Networks the gate admits beyond :func:`drqn_target_nets`: a Flatten
    of 2-D observations before a Dense layer and an LSTM with a deep plain
    head, and the per-instance MiniPOMDP's dueling LSTM(1, 8)."""
    return {
        "Flatten, Dense, LSTM, deep plain head": (dt.Chain(
            dt.Flatten(), dt.Dense(6, 12, torch.relu), dt.LSTM(12, 10),
            dt.Dense(10, 8, torch.tanh), dt.Dense(8, 5)), 37, 5, (2, 3)),
        "MiniPOMDP dueling LSTM(1, 8)": (dt.create_dueling_network(dt.Chain(
            dt.LSTM(1, 8), dt.Dense(8, 2))), 32, 8, (1,)),
    }


def _cases():
    """``{name: (network, N, T, obs shape)}`` on the CPU."""
    out = {name: (net, N, T, (fd.drqn_plan_for(net, T, N).in_dim,))
           for name, (net, N, T) in drqn_target_nets(torch, "cpu").items()}
    out.update(_more_nets())
    return out


CASES = list(_cases())


@pytest.fixture(autouse=True)
def _recorder():
    profiling.reset()
    yield
    profiling.reset()


def _inputs(name, seed=0):
    net, N, T, obs = _cases()[name]
    gen = torch.Generator().manual_seed(seed)
    params = net.init(gen)
    nobs = 10 * torch.rand((N, T) + obs, generator=gen)
    return net, params, nobs


@pytest.mark.parametrize("name", CASES)
def test_plain_route_is_the_networks_unroll(name):
    """Every admitted network: the CPU route gives what the fused steps
    computed before K11, bit for bit, and counts the twin."""
    net, params, nobs = _inputs(name)
    N, T = nobs.shape[:2]
    plan = fd.drqn_plan_for(net, T, N)
    assert plan is not None
    q = fd.drqn_target_q(plan, net, params, nobs)
    xs = nobs.transpose(0, 1)
    before, _ = net.apply_sequence(params, xs, net.init_state(N, "cpu"))
    assert q.shape == (N, T, plan.head.num_actions)
    assert torch.equal(q, before.transpose(0, 1))
    counters = profiling.snapshot()["counters"]
    assert counters["train.drqn_target_plain"] == {"": 1}
    assert "train.drqn_target_kernel" not in counters
    assert "kernels.launches" not in counters


def test_the_cuda_entry_refuses_what_k11_cannot_take():
    """Wrong observation widths, non-f32 parameters and CPU tensors raise
    before the library is touched."""
    name = "LSTM32 dueling (grid_drqn.learner)"
    net, params, nobs = _inputs(name)
    plan = fd.drqn_plan_for(net, nobs.shape[1], nobs.shape[0])
    with pytest.raises(ValueError, match="next_obs"):
        fd.drqn_target_q_cuda(plan, params, nobs[..., :1])
    with pytest.raises(ValueError, match="float32"):
        fd.drqn_target_q_cuda(
            plan, {k: v.double() for k, v in params.items()}, nobs)
    with pytest.raises(ValueError, match="CUDA"):
        fd.drqn_target_q_cuda(plan, params, nobs)
    assert "kernels.launches" not in profiling.snapshot()["counters"]
    assert profiling.counter("train.drqn_target_kernel") == 0


OBS, A, B, T, E, U = 3, 4, 8, 5, 8, 3


def _filled_buffer(seed=0, steps=40):
    """An episode buffer after a random lockstep stream (episodes end at
    random), open episodes dropped."""
    buf = dt.EpisodeReplayBuffer((OBS,), 64, B, T, 16, num_envs=E,
                                 device="cpu")
    state = buf.init()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        done = (torch.rand(E, generator=gen) < 0.25).float()
        state = buf.add_step(state, dt.TransitionBatch(
            torch.randn(E, OBS, generator=gen),
            torch.randint(0, A, (E,), generator=gen),
            torch.randn(E, generator=gen), torch.randn(E, OBS, generator=gen),
            done), done > 0)
    return buf, buf.reset_in_progress(state)


@pytest.fixture
def world_of_one():
    """A one-rank gloo process group in this process."""
    import torch.distributed as dist

    from deepqlearning_tpu_torch.parallel.launch import free_port

    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("route", ["K5", "K8 (data-parallel)"])
def test_both_fused_steps_call_it_once_per_step(route, monkeypatch, request):
    """Each call of the fused recurrent step takes the target's Q(s') from
    ``drqn_target_q`` once, over all U·B windows of its sample, and hands
    that tensor to the update as it is."""
    net = dt.create_dueling_network(dt.Chain(
        dt.LSTM(OBS, 12), dt.Dense(12, 8, torch.tanh), dt.Dense(8, A)))
    buf, state = _filled_buffer()
    params = net.init(torch.Generator().manual_seed(1))
    target = {k: v.clone() for k, v in params.items()}
    calls, handed = [], []
    target_q = fd.drqn_target_q

    def spy(plan, network, p, next_obs):
        q = target_q(plan, network, p, next_obs)
        calls.append((network, p, tuple(next_obs.shape), q))
        return q

    update = (fd.fused_drqn_group_update if route == "K5"
              else fd.fused_drqn_dp_group_update)

    def update_spy(*args, **kw):
        handed.append(args[11])  # q_sp_tgt
        return update(*args, **kw)

    monkeypatch.setattr(fd, "drqn_target_q", spy)
    monkeypatch.setattr(fd, update.__name__, update_spy)
    if route == "K5":
        step, opt = make_fused_grouped_drqn_train_step(net, buf, 0.95, True,
                                                       1e-2, U)
    else:
        step, opt = make_fused_dp_drqn_train_step(
            net, buf, 0.95, True, 1e-2, U,
            request.getfixturevalue("world_of_one"))
    ostate = opt.init(params)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        step(params, target, ostate, state, generator=gen)
    assert len(calls) == len(handed) == 2
    for (network, p, shape, q), h in zip(calls, handed):
        assert network is net and p is target
        assert shape == (U * B, T, OBS) and q.shape == (U * B, T, A)
        assert h is q
    assert profiling.counter("train.drqn_target_plain") == 2


# -------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K11 has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


CARD_NETS = list(drqn_target_nets(torch, "cpu"))


def _card_inputs(dev, name, seed=7):
    return drqn_target_inputs(torch, dev,
                              torch.Generator(device=dev).manual_seed(seed),
                              name)


def _within_reassociation(q, p):
    """K11 and the twin sum their dot products in other orders: rtol 1e-5
    and atol 1e-5 of max(1, |Q|)."""
    scale = max(1.0, float(p.abs().max()))
    assert torch.allclose(q, p, rtol=1e-5, atol=1e-5 * scale), float(
        (q - p).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_NETS)
def test_k11_equals_twin_eager(card, name):
    plan, net, params, nobs = _card_inputs(card, name)
    q = fd.drqn_target_q(plan, net, params, nobs)
    assert q.is_contiguous() and q.dtype == torch.float32
    _within_reassociation(q, fd.drqn_target_q_plain(net, params, nobs))
    assert torch.equal(q, fd.drqn_target_q(plan, net, params, nobs))
    assert profiling.counter("train.drqn_target_kernel") == 2
    assert profiling.counter("kernels.launches", "dq_drqn_target") == 2


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_NETS)
def test_k11_in_a_cuda_graph(card, name):
    """Captured once, replayed ten times: the eager call's bits on every
    replay."""
    plan, net, params, nobs = _card_inputs(card, name)
    eager = fd.drqn_target_q_cuda(plan, params, nobs)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        fd.drqn_target_q_cuda(plan, params, nobs)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.drqn_target_q_cuda(plan, params, nobs)
    for _ in range(10):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    _within_reassociation(out, fd.drqn_target_q_plain(net, params, nobs))


@pytest.mark.card
def test_k11_refuses_cpu_windows_on_the_card(card):
    name = "LSTM32 dueling (grid_drqn.learner)"
    plan, net, params, nobs = _card_inputs(card, name)
    with pytest.raises(ValueError, match="CUDA"):
        fd.drqn_target_q_cuda(plan, params, nobs.cpu())
    with pytest.raises(ValueError, match="next_obs"):
        fd.drqn_target_q_cuda(plan, params, nobs[:, :, :1])
