"""Kernel K10, a Conv2D or Dense layer's bias, activation and casts in one
launch forward and one backward (``deepqlearning_tpu_torch/ops/cuda/
bias_act.py``, ``csrc/bias_act.cu``).

On the CPU: the layers' epilogue (``models/chain.py::epilogue``, the
kernel's plain twin on a CPU tensor) gives exactly the numbers of the
chain the layers ran before K10, frozen below, for Conv2D and Dense, in f32
and bf16, with relu, tanh and no activation: the output and the gradients
of the input, the weight and the bias, bit for bit; the routing of an
activation or dtype that K10 does not take to that chain; the wrapper's
refusals, launch plans and counters; the segment's per-route counters;
the K10 launches per iteration that ``chip_smoke.py`` expects on each of
its compiled-segment routes.

On the card (marker ``card``; skipped without CUDA): K10 against the twin
at the cells' shapes (the IMPALA trunk's 32x84x84x16 and 32x20x20x32
activations, the Nature actor's 2048x20x20x32, the dueling streams' 32x512,
512x64, 16384x64 and their outputs of 1 and 4), eagerly and as a CUDA
graph replayed ten times: the output and the product's cotangent bit for
bit, the bias gradient within f32 reassociation of the twin's sum and the
same bits on every replay; ragged and unaligned rows; the subnormal ReLU
edge. On a card::

    python -m pytest --noconftest -m card tests/test_torch_bias_act_kernel.py
"""
import types

import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    LAYER_CALLS, make_collect_graph, make_segment)
from deepqlearning_tpu_torch.models.chain import (  # noqa: E402
    Conv2D, Dense, _ConvNoTF32, _nchw_same, dot_f32, epilogue)
from deepqlearning_tpu_torch.ops.cuda import bias_act as k10  # noqa: E402
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402

ACTS = {"relu": torch.relu, "tanh": torch.tanh, "none": None}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def frozen_dense(layer, x):
    """``Dense.forward`` as it ran before K10."""
    y = dot_f32(x, layer.w)
    if layer.b is not None:
        y = y + layer.b.float()
    if layer.activation is not None:
        y = layer.activation(y)
    return y.to(x.dtype)


def frozen_conv(layer, x):
    """``Conv2D.forward`` as it ran before K10."""
    xc, pad = _nchw_same(x, layer.kernel, layer.stride, layer.padding, 0.0)
    y = _ConvNoTF32.apply(xc, layer.w.to(x.dtype).permute(3, 2, 0, 1),
                          layer.stride, pad).permute(0, 2, 3, 1)
    y = y.float() + layer.b.float()
    if layer.activation is not None:
        y = layer.activation(y)
    return y.to(x.dtype)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _layer(kind, act, dtype, device="cpu", use_bias=True):
    gen = torch.Generator().manual_seed(3)
    if kind == "conv":
        layer = Conv2D(4, 6, (3, 3), (2, 2), "SAME", ACTS[act])
    else:
        layer = Dense(12, 6, ACTS[act], use_bias=use_bias)
    layer.init(gen, dtype)
    with torch.no_grad():  # a bias away from zero
        if layer.b is not None:
            layer.b.copy_(torch.randn(6, generator=gen).to(dtype))
    return layer.to(device)


def _input(kind, dtype, device="cpu", seed=4):
    gen = torch.Generator().manual_seed(seed)
    shape = (3, 9, 7, 4) if kind == "conv" else (5, 2, 12)
    x = torch.randn(shape, generator=gen)
    x.view(-1)[::11] = 0.0
    return x.to(dtype).to(device).requires_grad_()


def _grads(fn, layer, x, seed=5):
    """The output and the gradients of ``x`` and every parameter under a
    random cotangent (with zeros and -0.0)."""
    out = fn(layer, x)
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(out.shape, generator=gen)
    g.view(-1)[::7] = 0.0
    g.view(-1)[1::9] = -0.0
    params = [p for p in (layer.w, layer.b) if p is not None]
    grads = torch.autograd.grad(out, [x] + params, g.to(out.dtype).to(
        out.device))
    return [out.detach()] + list(grads)


def _bits(a, b):
    """Equal dtypes, shapes and bits (NaN and -0.0 included)."""
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert u.dtype == v.dtype and u.shape == v.shape, i
        as_int = {2: torch.int16, 4: torch.int32}[u.element_size()]
        assert torch.equal(u.contiguous().view(as_int),
                           v.contiguous().view(as_int)), i


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_cpu_epilogue_equals_frozen_chain(kind, dtype, act):
    """Output and every gradient bit for bit (-0.0 and NaN bits included)
    against the chain the layers ran before K10."""
    layer = _layer(kind, act, DTYPES[dtype])
    x = _input(kind, DTYPES[dtype])
    frozen = frozen_conv if kind == "conv" else frozen_dense
    _bits(_grads(lambda l, v: l(v), layer, x), _grads(frozen, layer, x))
    counters = profiling.snapshot()["counters"]
    assert counters["model.bias_act_plain"] == {"": 1}
    assert "model.bias_act_kernel" not in counters


@pytest.mark.parametrize("act", ["relu", "none"])
def test_cpu_dense_without_bias_and_f32_input_on_bf16_weights(act):
    """A Dense layer without a bias, and an f32 input against bf16
    weights (the product and the output in f32), as before K10."""
    layer = _layer("dense", act, torch.float32, use_bias=False)
    x = _input("dense", torch.float32)
    _bits(_grads(lambda l, v: l(v), layer, x), _grads(frozen_dense, layer, x))
    layer = _layer("dense", act, torch.bfloat16)
    x = _input("dense", torch.float32)
    _bits(_grads(lambda l, v: l(v), layer, x), _grads(frozen_dense, layer, x))


def _fake_cuda(t):
    """A CPU tensor's view that calls itself a CUDA tensor, for the
    wrapper's checks (which read only its metadata)."""
    return types.SimpleNamespace(
        is_cuda=True, dtype=t.dtype, shape=t.shape, dim=t.dim,
        numel=t.numel, device=torch.device("cuda", 0))


@pytest.mark.parametrize("act,dtype,takes", [
    (torch.relu, torch.bfloat16, True), (torch.tanh, torch.float32, True),
    (None, torch.bfloat16, True), (torch.sigmoid, torch.float32, False),
    (torch.nn.functional.relu, torch.bfloat16, False),
    (lambda y: y * 2, torch.float32, False),
    (torch.relu, torch.float16, False), (torch.relu, torch.float64, False)])
def test_routing_on_what_the_layer_observes(act, dtype, takes):
    """K10 takes relu, tanh and no activation (by identity) on f32 and
    bf16; any other activation callable or dtype keeps the ATen chain."""
    y = _fake_cuda(torch.zeros(4, 6, dtype=dtype))
    b = _fake_cuda(torch.zeros(6, dtype=dtype))
    assert k10.takes(y, b, act, dtype) is takes
    assert not k10.takes(torch.zeros(4, 6, dtype=dtype),
                         torch.zeros(6, dtype=dtype), act, dtype)
    # a bias of another length or on another device
    assert not k10.takes(y, _fake_cuda(torch.zeros(5, dtype=dtype)), act,
                         dtype)
    assert not k10.takes(y, torch.zeros(6, dtype=dtype), act, dtype)


def test_routing_declines_what_has_nothing_to_do():
    """No elements, or no bias, no activation and no cast (the chain runs
    no kernel there)."""
    f32, bf16 = torch.float32, torch.bfloat16
    y = _fake_cuda(torch.zeros(4, 6))
    assert not k10.takes(_fake_cuda(torch.zeros(0, 6)), None, torch.relu,
                         f32)
    assert not k10.takes(y, None, None, f32)
    assert k10.takes(y, None, None, bf16)
    assert k10.takes(y, None, torch.relu, f32)
    assert k10.takes(y, _fake_cuda(torch.zeros(6, dtype=bf16)), None, f32)


def test_layer_routes_an_unknown_activation_to_the_chain(monkeypatch):
    """A layer on the card hands relu to K10 and a sigmoid to the chain:
    :func:`epilogue` asks :func:`takes` with the layer's own product,
    bias, activation and dtype."""
    seen = []
    monkeypatch.setattr(k10, "bias_act", lambda *a: seen.append(a) or "k10")
    monkeypatch.setattr(k10, "takes", lambda y, b, act, dtype:
                        act is torch.relu)
    y, b = torch.ones(2, 3), torch.zeros(3)
    assert epilogue(y, b, torch.relu, torch.float32) == "k10"
    out = epilogue(y, b, torch.sigmoid, torch.bfloat16)
    assert torch.equal(out, torch.sigmoid(y).to(torch.bfloat16))
    assert len(seen) == 1 and seen[0][2] is torch.relu
    assert profiling.snapshot()["counters"]["model.bias_act_plain"] == {
        "": 1}


def test_wrapper_refuses_what_k10_cannot_take():
    y = _fake_cuda(torch.zeros(4, 6))
    b = torch.zeros(6)
    with pytest.raises(ValueError, match="CUDA tensor"):  # the wrapper
        k10.bias_act(torch.zeros(4, 6), b, torch.relu, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k10._check(torch.zeros(4, 6), b, torch.relu, torch.float32)
    with pytest.raises(ValueError, match="product is torch.float64"):
        k10._check(_fake_cuda(torch.zeros(4, 6, dtype=torch.float64)), b,
                   torch.relu, torch.float32)
    with pytest.raises(ValueError, match="output is torch.float16"):
        k10._check(y, b, torch.relu, torch.float16)
    with pytest.raises(ValueError, match="bias is torch.float64"):
        k10._check(y, b.double(), torch.relu, torch.float32)
    with pytest.raises(ValueError, match="activation"):
        k10._check(y, b, torch.sigmoid, torch.float32)
    with pytest.raises(ValueError, match="elements"):
        k10._check(_fake_cuda(torch.zeros(0, 6)), b, None, torch.float32)
    with pytest.raises(ValueError, match="bias of shape"):
        k10._check(y, torch.zeros(5), None, torch.float32)
    with pytest.raises(ValueError, match="bias of shape"):  # on the CPU
        k10._check(y, b, None, torch.float32)
    assert k10._check(y, _fake_cuda(b), torch.tanh, torch.bfloat16) == (
        4, 6, 2)


@pytest.mark.parametrize("M,C,vec,plan", [
    (32 * 84 * 84, 16, 8, (2, 128, 1024)),   # IMPALA's first stack, bf16
    (32 * 20 * 20, 32, 8, (4, 64, 200)),     # Nature conv 1, learner
    (2048 * 20 * 20, 32, 8, (4, 64, 1024)),  # Nature conv 1, actor
    (32, 512, 4, (128, 2, 16)),              # a 512-wide stream, f32 y
    (512, 64, 4, (16, 16, 32)),              # grid_mlp's 64-wide layers
    (16384, 64, 4, (16, 16, 1024)),
    (32, 1, 1, (1, 256, 1)), (32, 4, 4, (1, 256, 1)),
    (7, 3, 1, (3, 85, 1)), (3, 3000, 1, (256, 1, 3))])
def test_launch_plan(M, C, vec, plan):
    """A thread per 16-byte unit of a row, the block's other threads on
    other rows, the grid over the rows up to 1024 blocks."""
    assert k10.launch_plan(M, C, vec) == plan
    tx, ty, blocks = plan
    assert tx * ty <= k10.THREADS and (ty == 1 or tx == C // vec)
    # the backward: at most 264 blocks, 2 per SM
    assert k10.launch_plan(M, C, vec, k10.GRAD_BLOCKS) == (
        tx, ty, min(blocks, 264))


def test_vector_width_needs_alignment_and_a_whole_row():
    """16 bytes of the wider of the kernel's two types (the backward's:
    the cotangent's and the product's, whichever arrays it touches)."""
    f32, bf16 = torch.float32, torch.bfloat16
    buf = torch.zeros(4 * 64 + 4)
    assert k10._vec(64, (f32, f32), (buf[:256], torch.zeros(256))) == 4
    assert k10._vec(64, (f32, f32), (buf[1:257], torch.zeros(256))) == 1
    half = torch.zeros(256, dtype=bf16)
    assert k10._vec(64, (bf16, bf16), (half, half)) == 8
    assert k10._vec(64, (bf16, f32), (half, None, half)) == 4
    assert k10._vec(6, (f32, f32), (torch.zeros(12),)) == 1


def test_layer_calls_names_both_routes():
    assert {"bias_act_kernel", "bias_act_plain"} <= set(LAYER_CALLS)


@pytest.mark.parametrize("kernel,plain,share", [
    (90, 0, 100.0), (0, 90, 0.0), (3, 1, 75.0), (0, 0, None),
    (None, None, None), (12, None, 100.0)])
def test_bias_act_share_reader(kernel, plain, share, monkeypatch):
    """``port_bench``'s ``segment.bias_act_share``: K10's share of the
    segment's epilogues in %, None where the program put neither counter
    (a parent without K10) or the iteration ran no Conv2D or Dense."""
    from port_bench.harness.recorder import SEGMENT
    from port_bench.harness.registry import Registry

    counters = {f"segment.layer_calls.bias_act_{k}": {SEGMENT: v}
                for k, v in (("kernel", kernel), ("plain", plain))
                if v is not None}
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: dict(counters=counters))
    got = Registry().metric("segment.bias_act_share").read(None)
    assert got == (None if share is None else pytest.approx(share))


def _conv_loop():
    """A small dueling conv net on TestMDP under the IMPALA cell's traffic
    (32 envs, ``train_freq`` 4: U = 8 plain updates an iteration)."""
    env = dt.TestMDP((12, 12), 4, 6)
    net = dt.create_dueling_network(dt.Chain(
        dt.Conv2D(4, 4, (3, 3), (2, 2), "VALID", torch.relu), dt.Flatten(),
        dt.Dense(5 * 5 * 4, 16, torch.relu), dt.Dense(16, env.num_actions)))
    cfg = dt.DQNConfig(num_envs=32, batch_size=8, buffer_size=256,
                       train_freq=4, train_start=64, max_episode_length=6,
                       target_update_freq=64, seed=1)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 200),
                              env.discount)
    c = init_carry(env, net, buf, cfg, opt, "cpu")
    c = make_collect_graph(pop, c, cfg, env, buf, "k10 populate")(c, 4)
    return env, buf, cfg, it, c


def test_segment_puts_the_epilogue_routes_of_an_iteration():
    """An iteration's 18 forwards (the collect's, the target net's, and
    per update the online net's on s' and s) each run 5 epilogues (the
    conv and both streams' two Dense layers): 90 through the chain on the
    CPU, none through K10, put per route as ``segment.layer_calls.*``."""
    env, buf, cfg, it, c = _conv_loop()
    run = make_segment(it, c, cfg, env, buf, "k10 segment")
    before = profiling.counter("model.bias_act_plain")
    c = run(c, 2)
    counters = profiling.snapshot()["counters"]
    assert counters["segment.layer_calls.bias_act_plain"][
        "k10 segment"] == 18 * 5
    assert counters["segment.layer_calls.bias_act_kernel"][
        "k10 segment"] == 0
    assert profiling.counter("model.bias_act_plain") - before == 2 * 18 * 5
    assert sum(profiling.counter("kernels.launches", e)
               for e in ("dq_bias_act", "dq_bias_act_grad")) == 0


class _CountBackward(torch.autograd.Function):
    calls = 0

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _CountBackward.calls += 1
        return g


# ``chip_smoke.py`` phase 19's single-card routes at full width (its
# data-parallel routes need a process group)
SMOKE_ROUTES = ["headline", "U=1", "grouped plain", "conv", "conv f32",
                "CartPole", "DRQN", "DRQN plain", "per-instance GridWorld",
                "built-in GridWorld, plain collect",
                "per-instance MiniPOMDP DRQN"]


@pytest.mark.parametrize("route", SMOKE_ROUTES)
def test_smoke_routes_epilogues_per_iteration(route, monkeypatch):
    """The K10 launches per iteration that ``chip_smoke.py`` holds each
    route's graph replays to: the routes run the same layers on the CPU
    (the kernel wrappers' twins), so an iteration's epilogue forwards
    (``model.bias_act_plain`` here) and the backwards of those epilogues
    are its K10 forward and backward launches on the card, the table's
    entry points ``dq_bias_act`` and ``dq_bias_act_grad``; but those of
    K11's twin (the DRQN target's unroll) are K11's one launch there,
    ``dq_drqn_target``."""
    import chip_smoke

    from deepqlearning_tpu_torch.ops.cuda import fused_drqn

    plain, twin = k10.bias_act_plain, fused_drqn.drqn_target_q_plain
    k11 = {"calls": 0, "epilogues": 0}

    def counted(y, b, act, dtype):
        out = plain(y, b, act, dtype)
        return _CountBackward.apply(out) if out.requires_grad else out

    def target_twin(*args):
        before = profiling.counter("model.bias_act_plain")
        out = twin(*args)
        k11["calls"] += 1
        k11["epilogues"] += profiling.counter("model.bias_act_plain") - before
        return out

    monkeypatch.setattr(k10, "bias_act_plain", counted)
    monkeypatch.setattr(fused_drqn, "drqn_target_q_plain", target_twin)
    setup, per_iter = chip_smoke._segment_routes(
        torch, torch.device("cpu"))[route]
    it, c, cfg, _ = setup()
    c = it(c)  # fills the replay past one batch, as phase 19 does
    before = profiling.counter("model.bias_act_plain")
    _CountBackward.calls = 0
    k11.update(calls=0, epilogues=0)
    it(c)
    forwards = profiling.counter("model.bias_act_plain") - before
    assert (forwards - k11["epilogues"], _CountBackward.calls,
            k11["calls"]) == (per_iter.get("dq_bias_act", 0),
                              per_iter.get("dq_bias_act_grad", 0),
                              per_iter.get("dq_drqn_target", 0))


# -------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K10 has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


# (name, product shape, product dtype, bias and output dtype, activations):
# the cells' epilogues (the conv trunks in bf16; the dueling streams' f32
# products into bf16 in the Nature nets; grid_mlp's f32 layers)
SHAPES = [
    ("impala stack 1", (32, 84, 84, 16), "bf16", "bf16", ["relu", "none"]),
    ("impala stack 2", (32, 42, 42, 32), "bf16", "bf16", ["relu", "none"]),
    ("nature conv 1 learner", (32, 20, 20, 32), "bf16", "bf16", ["relu"]),
    ("nature conv 1 actor", (2048, 20, 20, 32), "bf16", "bf16", ["relu"]),
    ("nature stream", (32, 512), "f32", "bf16", ["relu"]),
    ("nature value", (32, 1), "f32", "bf16", ["none"]),
    ("nature advantage", (32, 4), "f32", "bf16", ["none"]),
    ("grid_mlp layer", (512, 64), "f32", "f32", ["tanh", "none"]),
    ("grid_mlp target", (16384, 64), "f32", "f32", ["tanh"]),
    ("grid_mlp advantage", (16384, 4), "f32", "f32", ["none"]),
    ("grid_mlp value", (512, 1), "f32", "f32", ["none"]),
]
CASES = [(name, shape, yd, od, act) for name, shape, yd, od, acts in SHAPES
         for act in acts]


def _case(shape, yd, od, device, seed=7, scale=3.0):
    """A product ``y`` (zeros and -0.0 among its values), a bias and a
    cotangent, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    y = scale * torch.randn(shape, generator=gen)
    y.view(-1)[::13] = 0.0
    y.view(-1)[5::17] = -0.0
    b = torch.randn(shape[-1], generator=gen)
    g = torch.randn(shape, generator=gen)
    return (y.to(DTYPES[yd]).to(device), b.to(DTYPES[od]).to(device),
            g.to(DTYPES[od]).to(device))


def _run(fn, y, b, act, dtype, g):
    """``(out, dy, db)`` of ``fn`` under the cotangent ``g``."""
    y = y.detach().requires_grad_()
    b = b.detach().requires_grad_()
    out = fn(y, b, act, dtype)
    dy, db = torch.autograd.grad(out, (y, b), g)
    return out.detach(), dy, db


def _sum_tolerance(dz, db):
    """The bias gradient's tolerance: an f32 sum of ``dz``'s rows in
    another order (|error| <= n · 2^-24 · Σ|dz| for n rows, taken at
    n = 2·log2(rows) + 2 for the tree sums on both sides), and one ulp of
    the bias's dtype where it is bf16."""
    rows = dz.reshape(-1, dz.shape[-1]).float()
    n = 2 * max(1, rows.shape[0]).bit_length() + 2
    tol = n * 2.0 ** -24 * rows.abs().sum(0)
    if db.dtype == torch.bfloat16:
        tol = tol + db.float().abs() * 2.0 ** -7
    return tol


def _bias_close(ours, want, dz):
    err = (ours.float() - want.float()).abs()
    assert bool((err <= _sum_tolerance(dz, want)).all()), float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("name,shape,yd,od,act", CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in CASES])
def test_k10_equals_twin_eager(card, name, shape, yd, od, act):
    y, b, g = _case(shape, yd, od, card)
    entries = ("dq_bias_act", "dq_bias_act_grad")
    launches = [profiling.counter("kernels.launches", e) for e in entries]
    out, dy, db = _run(k10.bias_act, y, b, ACTS[act], DTYPES[od], g)
    w_out, w_dy, w_db = _run(k10.bias_act_plain, y, b, ACTS[act],
                             DTYPES[od], g)
    torch.cuda.synchronize()
    # one forward and one backward launch
    assert [profiling.counter("kernels.launches", e)
            for e in entries] == [n + 1 for n in launches]
    _bits([out, dy], [w_out, w_dy])
    _bias_close(db, w_db, w_dy.float())
    counters = profiling.snapshot()["counters"]
    assert counters["model.bias_act_kernel"] == {"": 1}


@pytest.mark.card
@pytest.mark.parametrize("name,shape,yd,od,act", [
    c for c in CASES if c[0] in ("impala stack 1", "nature conv 1 actor",
                                 "nature stream", "grid_mlp target")],
    ids=lambda c: str(c))
def test_k10_in_a_cuda_graph(card, name, shape, yd, od, act):
    """K10's forward and backward captured with autograd, replayed ten
    times: the twin's output and product cotangent bit for bit, and the
    bias gradient the same bits on every replay and as the eager call."""
    y, b, g = _case(shape, yd, od, card, seed=11)
    fn, dtype = ACTS[act], DTYPES[od]
    eager = _run(k10.bias_act, y, b, fn, dtype, g)
    want = _run(k10.bias_act_plain, y, b, fn, dtype, g)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        for _ in range(2):
            _run(k10.bias_act, y, b, fn, dtype, g)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = _run(k10.bias_act, y, b, fn, dtype, g)
    for _ in range(10):
        graph.replay()
        torch.cuda.synchronize()
        _bits(list(static), list(eager))
        _bits(list(static[:2]), list(want[:2]))
    _bias_close(static[2], want[2], want[1].float())


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 3, 255, 257, 1001])
@pytest.mark.parametrize("C", [1, 3, 6, 16, 4100])
def test_k10_ragged_and_unaligned(card, rows, C):
    """Ragged rows, widths that are no multiple of a 16-byte unit (6
    actions; 4100 > 256 units a row), and products, biases and cotangents
    one element off 16-byte alignment (the scalar path)."""
    for yd, od, act in (("bf16", "bf16", "relu"), ("f32", "bf16", "none"),
                        ("f32", "f32", "tanh"), ("bf16", "bf16", "tanh")):
        y, b, g = _case((rows, C), yd, od, card, seed=rows * C)
        for shift in (False, True):
            if shift:
                y, b, g = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                           .view(t.shape) for t in (y, b, g))
                assert y.data_ptr() % 16
            out, dy, db = _run(k10.bias_act, y, b, ACTS[act], DTYPES[od], g)
            want = _run(k10.bias_act_plain, y, b, ACTS[act], DTYPES[od], g)
            _bits([out, dy], list(want[:2]))
            _bias_close(db, want[2], want[1].float())


@pytest.mark.card
@pytest.mark.parametrize("name,shape,yd,od,act", [
    c for c in CASES if c[0] in ("nature conv 1 learner", "nature stream",
                                 "grid_mlp layer")],
    ids=lambda c: str(c))
def test_k10_one_gradient_alone(card, name, shape, yd, od, act):
    """The product's cotangent alone (a bias that needs no gradient) and
    the bias gradient alone (a product that needs none)."""
    y, b, g = _case(shape, yd, od, card, seed=13)
    fn, dtype = ACTS[act], DTYPES[od]
    want = _run(k10.bias_act_plain, y, b, fn, dtype, g)
    yg = y.detach().requires_grad_()
    (dy,) = torch.autograd.grad(k10.bias_act(yg, b, fn, dtype), yg, g)
    _bits([dy], [want[1]])
    bg = b.detach().requires_grad_()
    (db,) = torch.autograd.grad(k10.bias_act(y, bg, fn, dtype), bg, g)
    _bias_close(db, want[2], want[1].float())


@pytest.mark.card
def test_k10_ticket_per_forward(card):
    """Each forward zeroes its own ticket for its backward: two layers'
    backwards in either order, and one backward run twice (its last block
    re-arms the ticket), give the same bias gradients."""
    cases = [_case((32, 20, 20, 32), "bf16", "bf16", card, seed=s)
             for s in (21, 22)]
    want = [_run(k10.bias_act_plain, y, b, torch.relu, torch.bfloat16, g)
            for y, b, g in cases]
    bs = [b.detach().requires_grad_() for _, b, _ in cases]
    outs = [k10.bias_act(y, b, torch.relu, torch.bfloat16)
            for (y, _, _), b in zip(cases, bs)]
    first = [torch.autograd.grad(outs[i], bs[i], cases[i][2],
                                 retain_graph=True)[0] for i in (1, 0)][::-1]
    again = [torch.autograd.grad(o, b, c[2])[0]
             for o, b, c in zip(outs, bs, cases)]
    for f, a, w in zip(first, again, want):
        assert torch.equal(f, a)
        _bias_close(f, w[2], w[1].float())


@pytest.mark.card
def test_k10_strided_product_and_no_bias(card):
    """A product that is a strided view (made contiguous first), and a
    layer without a bias (no bias gradient)."""
    y, b, g = _case((64, 40), "f32", "bf16", card)
    view = y[:, ::2]
    gv = g[:, ::2].contiguous()
    out, dy, db = _run(k10.bias_act, view, b[:20], torch.relu,
                       torch.bfloat16, gv)
    want = _run(k10.bias_act_plain, view, b[:20], torch.relu,
                torch.bfloat16, gv)
    _bits([out, dy], list(want[:2]))
    yv = view.detach().requires_grad_()
    out = k10.bias_act(yv, None, torch.relu, torch.bfloat16)
    (dy,) = torch.autograd.grad(out, yv, gv)
    w_out = k10.bias_act_plain(yv, None, torch.relu, torch.bfloat16)
    (w_dy,) = torch.autograd.grad(w_out, yv, gv)
    _bits([out.detach(), dy], [w_out.detach(), w_dy])


@pytest.mark.card
def test_k10_relu_edges(card):
    """NaN stays NaN and -0.0 goes to +0.0 as clamp_min's; a bf16 result
    in (0, 2^-134] rounds to zero, so K10's mask (read from the stored
    bf16 output) drops the cotangent there, where ATen's (read from the
    f32 result) passed it; at 2^-133, bf16's least subnormal, both pass
    it."""
    vals = torch.tensor([float("nan"), -0.0, 0.0, 2.0 ** -140, 2.0 ** -134,
                         2.0 ** -133, 1.5, -2.0], device=card)
    y = vals.repeat(64, 1)  # f32 product, bf16 output: the Dense route
    b = torch.zeros(vals.numel(), dtype=torch.bfloat16, device=card)
    g = torch.ones_like(y, dtype=torch.bfloat16)
    out, dy, _ = _run(k10.bias_act, y, b, torch.relu, torch.bfloat16, g)
    w_out, w_dy, _ = _run(k10.bias_act_plain, y, b, torch.relu,
                          torch.bfloat16, g)
    _bits([out], [w_out])
    edge = torch.tensor([False, False, False, True, True, False, False,
                         False], device=card).repeat(64, 1)
    assert torch.equal(dy[~edge], w_dy[~edge])
    assert bool((dy[edge] == 0).all()) and bool((w_dy[edge] == 1).all())
    assert bool((out[edge] == 0).all())
    # an f32 output keeps the f32 result, so the mask is exact there
    out, dy, _ = _run(k10.bias_act, y, b.float(), torch.relu,
                      torch.float32, g.float())
    want = _run(k10.bias_act_plain, y, b.float(), torch.relu,
                torch.float32, g.float())
    _bits([out, dy], list(want[:2]))


@pytest.mark.card
def test_k10_layers_on_the_card(card):
    """Conv2D and Dense layers in bf16 (relu, none) and f32 (tanh):
    K10's output and the input and weight gradients bit for bit against
    the frozen chain on the same card, the bias gradient within f32
    reassociation."""
    for kind, dtype, act in (("conv", "bf16", "relu"), ("conv", "bf16",
                                                         "none"),
                             ("dense", "bf16", "relu"),
                             ("dense", "f32", "tanh")):
        layer = _layer(kind, act, DTYPES[dtype], card)
        x = _input(kind, DTYPES[dtype], card)
        frozen = frozen_conv if kind == "conv" else frozen_dense
        ours = _grads(lambda l, v: l(v), layer, x)
        want = _grads(frozen, layer, x)
        _bits(ours[:3], want[:3])
        assert torch.allclose(ours[3].float(), want[3].float(),
                              rtol=2 ** -7, atol=1e-6)
    counters = profiling.snapshot()["counters"]
    assert counters["model.bias_act_kernel"] == {"": 4}
    assert "model.bias_act_plain" not in counters


@pytest.mark.card
def test_k10_refuses_on_the_card(card):
    y = torch.zeros(4, 6, device=card)
    with pytest.raises(ValueError, match="activation"):
        k10.bias_act(y, None, torch.sigmoid, torch.float32)
    with pytest.raises(ValueError, match="bias of shape"):
        k10.bias_act(y, torch.zeros(6), torch.relu, torch.float32)
    with pytest.raises(ValueError, match="product is torch.float16"):
        k10.bias_act(y.half(), None, torch.relu, torch.float32)
