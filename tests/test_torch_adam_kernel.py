"""Kernel K9, the plain train steps' Adam update and gradient max-abs in one
launch (``deepqlearning_tpu_torch/ops/cuda/adam.py``, ``csrc/adam.cu``).

On the CPU: ``Adam.update`` (the wrapper's plain twin) gives exactly the
numbers of the chain the plain steps ran before K9 (``Adam.update``'s ATen
loop after ``globalnorm``), frozen below, at the parameter shapes of the
benchmark's two configurations (the 2-64-64-4 dueling MLP in f32, the
Nature DQN trunk with 512-wide dueling streams in bf16); the kernel's
tables and grids; the refusals; the recorder's counters.

On the card (marker ``card``; skipped without CUDA): K9 against the plain
twin on the card, bit for bit (``torch.equal``) on params, moments, count
and max-abs, at both shapes, steps 1-5 and from a count of 10^5 (and the
bias corrections K9 takes on the device at 600 counts to 10^8), with
zeros, -0.0, wide-ranging magnitudes, lengths that are not a multiple of
the 16-byte vector, unaligned views, more tensors than one table holds,
eagerly and as a CUDA graph replayed 3 times. On a card::

    python -m pytest --noconftest -m card tests/test_torch_adam_kernel.py
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    AdamState, make_optimizer)
from deepqlearning_tpu_torch.ops.cuda import adam as k9  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import build  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda.kernel_events import (  # noqa: E402
    adam_nets)
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402

# tensors and parameters of the two configurations (port_bench/configs/)
NETS = {"grid_dueling_mlp f32": (12, 9029),
        "nature_dueling_dqn bf16": (14, 3292837)}


def _params(name, device, seed=0):
    """``(learning rate, params)`` of a configuration (``kernel_events.
    adam_nets``), from ``seed``, on ``device``."""
    net, dtype, lr = adam_nets(torch, "cpu")[name]
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.detach().clone().to(device)
              for k, v in net.init(gen, dtype).items()}
    assert (len(params), sum(p.numel() for p in params.values())) == NETS[
        name]
    return lr, params


def _grads(params, seed):
    """Gradients over six decades, with zeros and -0.0 in each tensor."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, (k, p) in enumerate(params.items()):
        g = torch.randn(p.shape, generator=gen) * 10.0 ** (i % 7 - 4)
        flat = g.view(-1)
        flat[::5] = 0.0
        flat[1::7] = -0.0
        out[k] = g.to(p.dtype).to(p.device)
    return out


def _state(params, count, seed):
    gen = torch.Generator().manual_seed(seed)
    dev = next(iter(params.values())).device
    m = {k: (1e-3 * torch.randn(p.shape, generator=gen)).to(p.dtype).to(dev)
         for k, p in params.items()}
    v = {k: (1e-6 * torch.rand(p.shape, generator=gen)).to(p.dtype).to(dev)
         for k, p in params.items()}
    return AdamState(m, v, torch.tensor(count, dtype=torch.int32, device=dev))


def _clone(params, state):
    return ({k: t.clone() for k, t in params.items()},
            AdamState({k: t.clone() for k, t in state.m.items()},
                      {k: t.clone() for k, t in state.v.items()},
                      state.count.clone()))


def frozen_chain(lr, grads, state, params):
    """The plain steps' ``globalnorm(grads)`` and ``Adam.update`` as they
    ran before K9, frozen."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    gnorm = torch.stack([g.abs().max().float() for g in grads.values()]).max()
    with torch.no_grad():
        state.count.add_(1)
        t = state.count.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for k, g in grads.items():
            m, v, p = state.m[k], state.v[k], params[k]
            c1, rb1, c2, rb2, reps, neg_lr = (
                torch.tensor(x, dtype=p.dtype).item()
                for x in (1.0 - b1, b1, 1.0 - b2, b2, eps, -lr))
            m.mul_(rb1).add_(c1 * g)
            v.mul_(rb2).add_(c2 * (g * g))
            p.add_(neg_lr * ((m / bc1.to(m.dtype))
                             / (torch.sqrt(v / bc2.to(v.dtype)) + reps)))
    return gnorm


def _same(a, b):
    (pa, sa), (pb, sb) = a, b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), f"param {k}"
        assert torch.equal(sa.m[k], sb.m[k]), f"m {k}"
        assert torch.equal(sa.v[k], sb.v[k]), f"v {k}"
    assert torch.equal(sa.count, sb.count)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("count", [0, 10 ** 5])
@pytest.mark.parametrize("name", list(NETS))
def test_plain_dispatch_equals_frozen_chain(name, count):
    lr, params = _params(name, "cpu")
    opt = make_optimizer(lr)
    state = _state(params, count, 1)
    ours = (params, state)
    ref = _clone(params, state)
    for step in range(3):
        grads = _grads(params, 10 + step)
        _, gnorm = opt.update(grads, ours[1], ours[0])
        want = frozen_chain(lr, grads, ref[1], ref[0])
        assert gnorm.dtype == torch.float32 and gnorm.shape == ()
        assert torch.equal(gnorm, want)
        _same(ours, ref)
    assert int(state.count) == count + 3


@pytest.mark.parametrize("name", list(NETS))
def test_tables(name):
    lr, params = _params(name, "cpu")
    state = _state(params, 0, 1)
    grads = _grads(params, 2)
    rows = [(params[k], state.m[k], state.v[k], g) for k, g in grads.items()]
    opt = make_optimizer(lr)
    dtype = rows[0][0].dtype
    (tab,) = k9.adam_tables(rows, {dtype: opt._rounded(dtype)})
    per_unit = 16 // torch.tensor([], dtype=dtype).element_size()
    unit = 0
    for i, (p, m, v, g) in enumerate(rows):
        assert (tab.p[i], tab.m[i], tab.v[i], tab.g[i]) == tuple(
            t.data_ptr() for t in (p, m, v, g))
        assert tab.n[i] == p.numel() and tab.start[i] == unit
        aligned = all(t.data_ptr() % 16 == 0 for t in (p, m, v, g))
        assert tab.flags[i] == k9.DTYPES[dtype] + 2 * aligned
        unit += -(-p.numel() // per_unit)
    assert tab.nt == len(rows) and tab.start[tab.nt] == unit
    assert list(tab.k[k9.DTYPES[dtype]]) == list(opt._rounded(dtype))
    assert ctypes.sizeof(build.AdamTab) == 2872  # the C struct's size


def test_tables_chunk_and_flag_unaligned_views():
    """More than ``AD_MAXT`` tensors take several tables, each counting
    its units from 0; views at 4-byte offsets of one flat vector (the
    data-parallel steps' gradients) are flagged unaligned."""
    flat = torch.zeros(4 * 70 + 3)
    p = [flat[4 * i + 1:4 * i + 5] for i in range(70)]
    rows = [(t, t, t, t) for t in p]
    tabs = k9.adam_tables(rows, {torch.float32: (0.0,) * 6})
    assert [t.nt for t in tabs] == [64, 6]
    assert [t.start[t.nt] for t in tabs] == [64, 6]
    assert all(t.flags[i] == 0 for t in tabs for i in range(t.nt))
    whole = torch.zeros(16)
    (tab,) = k9.adam_tables([(whole[:13],) * 4],
                            {torch.float32: (0.0,) * 6})
    assert tab.flags[0] == 2 and tab.start[1] == 4


def test_launch_grids():
    # a unit per thread while the blocks fit in one wave
    assert k9.launch_grids([2258]) == [9]
    assert k9.launch_grids([1]) == [1]
    # the Nature net's 411,617 bf16 units: two per thread in 804 blocks
    assert k9.launch_grids([411617]) == [804]
    # two tables share the resident blocks
    grids = k9.launch_grids([300000, 300000])
    assert sum(grids) <= build.AD_MAXB and grids[0] == grids[1]


def test_rows_refuse_what_k9_cannot_take():
    lr, params = _params("grid_dueling_mlp f32", "cpu")
    state = _state(params, 0, 1)
    grads = _grads(params, 2)
    k = next(iter(params))
    bad = dict(params, **{k: params[k].double()})
    with pytest.raises(ValueError, match="float64"):
        k9.adam_rows(grads, state, bad)
    w = [n for n, t in params.items() if t.dim() == 2][0]
    bad = dict(params, **{w: params[w].t().contiguous().t()})
    with pytest.raises(ValueError, match="not contiguous"):
        k9.adam_rows(grads, state, bad)
    with pytest.raises(ValueError, match="gradient"):
        k9.adam_rows(dict(grads, **{k: grads[k].double()}), state, params)
    with pytest.raises(ValueError, match="CUDA device"):
        k9.adam_rows(grads, state, params)


def test_counters_on_the_cpu():
    lr, params = _params("grid_dueling_mlp f32", "cpu")
    opt = make_optimizer(lr)
    state = opt.init(params)
    launches = profiling.counter("kernels.launches", "dq_adam_update")
    for step in range(3):
        opt.update(_grads(params, step), state, params)
    counters = profiling.snapshot()["counters"]
    assert counters["train.adam_plain"] == {"": 3}
    assert "train.adam_kernel" not in counters
    assert profiling.counter("kernels.launches", "dq_adam_update") == launches


# -------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K9 has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _kernel_vs_twin(opt, params, state, steps, seed):
    ours = (params, state)
    ref = _clone(params, state)
    for s in range(steps):
        grads = _grads(params, seed + s)
        gnorm = k9.adam_update(opt, grads, ours[1], ours[0])
        want = k9.adam_update_plain(opt, grads, ref[1], ref[0])
        assert torch.equal(gnorm, want), (s, float(gnorm), float(want))
        _same(ours, ref)


@pytest.mark.card
@pytest.mark.parametrize("count", [0, 10 ** 5])
@pytest.mark.parametrize("name", list(NETS))
def test_k9_equals_twin_eager(card, name, count):
    lr, params = _params(name, card)
    opt = make_optimizer(lr)
    launches = profiling.counter("kernels.launches", "dq_adam_update")
    _kernel_vs_twin(opt, params, _state(params, count, 3), 5, 20)
    torch.cuda.synchronize()
    assert profiling.counter("kernels.launches",
                             "dq_adam_update") == launches + 5
    counters = profiling.snapshot()["counters"]
    assert counters["train.adam_kernel"] == {"": 5}
    assert counters["train.adam_plain"] == {"": 5}  # the twin's own calls


@pytest.mark.card
def test_k9_ragged_unaligned_and_chunked(card):
    """Odd lengths (1, 3, 13, 4099 elements), f32 views at 4-byte offsets
    of one flat vector (the data-parallel steps' gradients), bf16 tensors
    beside f32 ones, and 70 tensors (two tables, two launches sharing one
    max-abs)."""
    gen = torch.Generator().manual_seed(5)
    sizes = [1, 3, 13, 4099] + [7 * i + 1 for i in range(66)]
    params = {f"t{i}": torch.randn(n, generator=gen).to(
        torch.bfloat16 if i % 3 == 0 else torch.float32).to(card)
        for i, n in enumerate(sizes)}
    opt = make_optimizer(1e-3)
    launches = profiling.counter("kernels.launches", "dq_adam_update")
    _kernel_vs_twin(opt, params, _state(params, 0, 6), 3, 30)
    assert profiling.counter("kernels.launches",
                             "dq_adam_update") == launches + 6
    flat = torch.randn(4 * 3000 + 1, generator=gen).to(card)
    views = {f"w{i}": flat[1 + 1000 * i:1 + 1000 * (i + 1)] for i in range(3)}
    params = {k: torch.randn(1000, generator=gen).to(card) for k in views}
    state = _state(params, 7, 8)
    ref = _clone(params, state)
    gnorm = k9.adam_update(opt, views, state, params)
    want = k9.adam_update_plain(opt, views, ref[1], ref[0])
    assert torch.equal(gnorm, want)
    _same((params, state), ref)


@pytest.mark.card
@pytest.mark.parametrize("name", list(NETS))
def test_k9_in_a_cuda_graph(card, name):
    """K9 captured with its gradients' producer, replayed 3 times, against
    the twin run eagerly on the same gradients."""
    lr, params = _params(name, card)
    opt = make_optimizer(lr)
    state = _state(params, 0, 9)
    ref = _clone(params, state)
    src = _grads(params, 40)
    static = {k: torch.empty_like(g) for k, g in src.items()}
    scale = torch.ones((), device=card)

    def step():
        for k, g in src.items():
            static[k].copy_(g * scale.to(g.dtype))
        return k9.adam_update(opt, static, state, params)

    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        out = step()
    torch.cuda.current_stream(card).wait_stream(side)
    want = k9.adam_update_plain(opt, src, ref[1], ref[0])
    assert torch.equal(out, want)
    _same((params, state), ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for s in range(3):
        scale.fill_(0.5 ** s)
        graph.replay()
        grads = {k: g * scale.to(g.dtype) for k, g in src.items()}
        want = k9.adam_update_plain(opt, grads, ref[1], ref[0])
        assert torch.equal(out, want), s
        _same((params, state), ref)


@pytest.mark.card
def test_k9_count_and_bias_corrections(card):
    """K9 adds 1 to the count and takes 1 - β^t on the device as the
    twin's ATen kernels do: with p = 0 and a learning rate of 1 the update
    is -m̂ / (√v̂ + ε), which shows the last bit of each bias correction,
    in f32 and bf16, at every count to 300 and 300 more to 10^8."""
    gen = torch.Generator().manual_seed(11)
    counts = list(range(300)) + sorted(
        {int(10 ** (2.5 + 5.5 * i / 299)) for i in range(300)})
    opt = make_optimizer(1.0)
    for dtype in (torch.float32, torch.bfloat16):
        params = {"w": torch.zeros(4096, dtype=dtype, device=card)}
        grads = {"w": torch.randn(4096, generator=gen).to(dtype).to(card)}
        for c in counts:
            state = _state(params, c, c)
            ours = ({"w": params["w"].clone()}, state)
            ref = _clone(*ours)
            gnorm = k9.adam_update(opt, grads, ours[1], ours[0])
            want = k9.adam_update_plain(opt, grads, ref[1], ref[0])
            assert torch.equal(gnorm, want)
            _same(ours, ref)
            assert int(ours[1].count) == c + 1, (dtype, c)


@pytest.mark.card
def test_k9_refuses_on_the_card(card):
    lr, params = _params("grid_dueling_mlp f32", card)
    opt = make_optimizer(lr)
    state = opt.init(params)
    grads = _grads(params, 1)
    k = next(iter(params))
    bad = dict(params, **{k: params[k].double()})
    with pytest.raises(ValueError, match="float64"):
        k9.adam_update(opt, grads, state, bad)
    w = [n for n, t in params.items() if t.dim() == 2][0]
    bad = dict(params, **{w: params[w].t().contiguous().t()})
    with pytest.raises(ValueError, match="not contiguous"):
        k9.adam_update(opt, grads, state, bad)
    assert int(state.count) == 0  # refused before the count moved
