"""The Soft MoE layer (Puigcerver et al. 2023) in place of the penultimate
layer of a dueling DQN on the IMPALA trunk (Obando-Ceron et al. 2024), on
the port (``models/chain.py::SoftMoE``).

On the CPU: the layer against the benchmark's plain reference
(``port_bench/layers/SoftMoE.py``), forward and every gradient, in f32 and
bf16; the same comparison failing with the two softmax axes swapped; the
dueling net against ``reference/nets.py::Net``; the experts' bias and ReLU
handed to K10 as one ``[N, p, n·hidden]`` epilogue, and the one bf16
product Function taking the experts' batched product; the kernel plans
declining the net; a few iterations of ``solve``; the segment's
``segment.layer_calls.soft_moe``; the benchmark's check of a tiny cell
reading ``correct``, and not with the fault planted; the readers of
``segment.moe_calls`` and ``moe.device_share``.

On the card (marker ``card``; skipped without CUDA): the layer at the cell
``impala_moe.learner``'s shapes against the plain reference, and as a CUDA
graph replayed bit for bit::

    python -m pytest --noconftest -m card tests/test_torch_soft_moe.py
"""
import json
import math
import shutil
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    make_collect_graph, make_segment)
from deepqlearning_tpu_torch.ops.cuda import bias_act as k10  # noqa: E402
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ARGS = [8, 4, 2, 16]  # d, experts, slots per expert, hidden


def _registry():
    from port_bench.harness.registry import Registry

    return Registry()


def _part():
    from port_bench.harness.registry import load_module

    return load_module(BENCH / "layers" / "SoftMoE.py")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def swapped(logits, dtype):
    """The planted fault: each softmax over the other's axis."""
    return (torch.softmax(logits, dim=2).to(dtype),
            torch.softmax(logits, dim=1).to(dtype))


def _ulps_apart(a, b):
    """The largest gap of two tensors in units of bf16's last place at the
    scale of the larger tensor's largest magnitude."""
    a, b = a.detach().float(), b.detach().float()
    scale = max(float(a.abs().max()), float(b.abs().max()))
    _, e = math.frexp(scale)
    return float((a - b).abs().max()) / 2.0 ** (e - 8)


def _both(part, layer, params, x, gy, args=ARGS):
    """``[y, dx, d<param>...]`` of the port's layer and of the plain
    forward of ``args``, from the same parameters and cotangent ``gy``."""
    from torch.func import functional_call

    from port_bench.reference.nets import Precision

    outs = []
    for fwd in (lambda xx, pp: functional_call(
                    layer, {k[2:]: v for k, v in pp.items()}, (xx,)),
                lambda xx, pp: part.forward(xx, pp, "s", args,
                                            Precision())):
        xx = x.clone().requires_grad_()
        pp = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
        with Precision().flags():
            y = fwd(xx, pp)
            grads = torch.autograd.grad(y, [xx] + list(pp.values()), gy)
        outs.append([y.detach()] + [g.detach() for g in grads])
    return outs


def _layer_case(dtype, device="cpu", n=6):
    """``SoftMoE(8, 4, 2, 16)`` on seeded weights, a ReLU'd ``[n, 5, 5,
    8]`` map and a cotangent, and its parameters keyed under ``s``."""
    part = _part()
    layer = part.program(ARGS, device)
    params = {f"s.{k}": v for k, v in layer.init(
        torch.Generator().manual_seed(3), dtype).items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(n, 5, 5, 8, generator=gen).relu().to(dtype)
    gy = torch.randn(n, 25, 16, generator=gen).to(dtype)
    return part, layer, params, x.to(device), gy.to(device)


def _bias_tolerance(dz):
    """The bias gradient's f32 tolerance from the cotangent ``dz`` of the
    experts' product ``[N, p, n·H]``: the port sums each bias's ``N·p``
    terms in one pass over the rows, the reference per expert's slots, the
    same terms in another order (|error| <= k · 2^-24 · Σ|terms|, k =
    2·log2(N·p) + 2 for tree sums on both sides)."""
    rows = dz.reshape(-1, dz.shape[-1])
    return (2 * rows.shape[0].bit_length() + 2) * 2.0 ** -24 * rows.abs(
    ).sum(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_matches_the_reference(dtype, monkeypatch):
    """``SoftMoE(8, 4, 2, 16)`` on a 5x5x8 map: the output, the input
    gradient and every parameter's gradient against the plain forward of
    ``port_bench/layers/SoftMoE.py`` (f32 products on f32 copies, TF32 off,
    the same roundings). In f32 bit for bit but the bias gradient, within
    f32 reassociation of its sum (:func:`_bias_tolerance`); in bf16 within
    one unit in the last place at the tensor's scale, since a sum rounded
    to bf16 from f32 sums taken in another order can land one ulp apart.
    The shape, parameters and multiply-adds as the file counts them."""
    from deepqlearning_tpu_torch.models import chain

    part, layer, params, x, gy = _layer_case(dtype)
    dz, epilogue = [], chain.epilogue

    def kept(y, b, act, dtype):
        y.register_hook(dz.append)
        return epilogue(y, b, act, dtype)

    monkeypatch.setattr(chain, "epilogue", kept)
    ours, ref = _both(part, layer, params, x, gy)
    assert sorted(params) == ["s.b", "s.phi", "s.w"]
    assert part.n_params(ARGS) == sum(v.numel() for v in params.values())
    assert tuple(ours[0].shape[1:]) == part.out_shape((5, 5, 8), ARGS)
    assert ours[0].dtype == dtype
    assert part.macs((5, 5, 8), ARGS) == 25 * 8 * 8 * 2 + 8 * 8 * 16 + (
        25 * 8 * 16)
    names = ["y", "x", "phi", "w", "b"]
    for name, a, b in zip(names, ours, ref):
        if dtype == torch.float32 and name == "b":
            assert bool(((a - b).abs() <= _bias_tolerance(dz[0])).all())
        elif dtype == torch.float32:
            assert torch.equal(a, b), name
        else:
            assert _ulps_apart(a, b) <= 1.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swapped_softmax_axes_fail_the_comparison(dtype, monkeypatch):
    """The planted fault, each softmax over the other's axis
    (``SoftMoE._weights``): the output leaves every tolerance of
    :func:`test_layer_matches_the_reference` by far, the largest gap more
    than a tenth of the output's scale."""
    part, layer, params, x, gy = _layer_case(dtype)
    monkeypatch.setattr(dt.SoftMoE, "_weights", staticmethod(swapped))
    ours, ref = _both(part, layer, params, x, gy)
    assert _ulps_apart(ours[0], ref[0]) > 2.0 ** 7 * 0.1


def test_experts_hand_their_epilogue_to_k10(monkeypatch):
    """On the card the experts' bias and ReLU are one K10 launch: the
    layer asks :func:`bias_act.takes` with the experts' f32 product laid
    out ``[N, p, n·hidden]`` (one row per sample and slot, the experts side
    by side), the biases ``[n·hidden]`` as one vector, ``torch.relu`` and
    the input's dtype, and hands that call to K10 (``bias_act.bias_act``,
    stood in for here by the twin), once per forward."""
    seen = []

    def k10_stand_in(y, b, act, dtype):
        seen.append((tuple(y.shape), y.dtype, tuple(b.shape), act, dtype))
        return k10.bias_act_plain(y, b, act, dtype)

    monkeypatch.setattr(k10, "takes", lambda y, b, act, dtype: True)
    monkeypatch.setattr(k10, "bias_act", k10_stand_in)
    _part_, layer, params, x, _gy = _layer_case(torch.bfloat16, n=3)
    y = layer(x)
    assert seen == [((3, 2, 4 * 16), torch.float32, (4 * 16,), torch.relu,
                     torch.bfloat16)]
    assert profiling.counter("model.soft_moe") == 1
    # on the CPU the same epilogue runs the chain, to the same bits
    monkeypatch.undo()
    want = layer(x)
    assert torch.equal(y, want)
    assert profiling.counter("model.bias_act_plain") == 2


def test_one_product_function_takes_the_batch():
    """``dot_f32`` takes the experts' batched product ``[n, R, d] @ [n, d,
    H]`` as it takes a 2-D one: on the CPU each expert's product, and on
    the card ``_DotBF16``, whose backward (called here without the card's
    forward) gives each batched gradient in its operand's dtype and
    layout, the bits of autograd through ``x.float() @ w.float()``; the
    2-D route's backward is unchanged by the batched one."""
    from types import SimpleNamespace

    from deepqlearning_tpu_torch.models.chain import _DotBF16, dot_f32

    gen = torch.Generator().manual_seed(8)
    rows = torch.randn(6, 4, 8, generator=gen)  # [R, n, d]: experts inner
    w = torch.randn(4, 8, 16, generator=gen)
    out = dot_f32(rows.transpose(0, 1), w)
    for e in range(4):
        assert torch.equal(out[e], rows[:, e] @ w[e])
    for x, w in ((rows.transpose(0, 1).bfloat16(), w.bfloat16()),
                 (torch.randn(3, 5, 8, generator=gen).bfloat16(),
                  torch.randn(8, 16, generator=gen).bfloat16())):
        g = torch.randn(x.shape[:-1] + w.shape[-1:], generator=gen)
        ctx = SimpleNamespace(saved_tensors=(x, w),
                              needs_input_grad=(True, True))
        gx, gw = _DotBF16.backward(ctx, g)
        xx, ww = (t.detach().requires_grad_() for t in (x, w))
        want = torch.autograd.grad(xx.float() @ ww.float(), (xx, ww), g)
        for got, ref, like in ((gx, want[0], x), (gw, want[1], w)):
            assert got.dtype == like.dtype and got.shape == like.shape
            assert torch.equal(got, ref)


# --- the whole dueling net -------------------------------------------------
def _spec(dtype):
    layers = [["ImpalaStack", 4, 16], ["ImpalaStack", 16, 32],
              ["ImpalaStack", 32, 32], ["ReLU"], ["SoftMoE", 32, 4, 2, 16],
              ["Flatten"], ["Dense", 3 * 3 * 16, 4, None]]
    if dtype == torch.bfloat16:
        layers.insert(0, ["Cast", "bfloat16"])
    return {"layers": layers, "dueling": True}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dueling_net_matches_the_reference_net(dtype):
    """The IMPALA trunk at 20x20x4 frames (20 -> 10 -> 5 -> 3) with
    ``SoftMoE(32, 4, 2, 16)`` over its 9 positions and dueling heads over
    the 144 flattened outputs: the port's Q values on seeded weights
    against ``reference.nets.Net``'s from the same parameter dict, bit for
    bit in f32 and within two bf16 units in the last place in bf16 (the
    CPU's bf16 convolutions sum apart from the reference's f32 ones, as in
    ``test_torch_impala_resnet.py``); the parameter count and the layer's
    multiply-adds as the reference counts them."""
    from port_bench.harness.program import _net
    from port_bench.reference.nets import Net

    reg = _registry()
    spec = _spec(dtype)
    net = _net(spec, reg, "cpu")
    assert isinstance(net.base.layers[-1], dt.Flatten)
    assert [type(l) for l in net.adv.layers] == [dt.Dense]
    params = net.init(torch.Generator().manual_seed(11), dtype)
    ref = Net(spec, reg, (20, 20, 4))
    assert ref.n_params() == sum(v.numel() for v in params.values())
    base, val, adv = ref.macs()
    assert base[-1] == 9 * 32 * 8 * 2 + 8 * 32 * 16 + 9 * 8 * 16
    assert (val, adv) == ([144], [144 * 4])
    obs = torch.rand(7, 20, 20, 4, generator=torch.Generator().manual_seed(
        12))
    with torch.no_grad():
        q, _ = net.apply(params, obs)
        q_ref, _ = ref.q(params, obs)
    assert q.dtype == q_ref.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(q, q_ref)
    else:
        assert _ulps_apart(q, q_ref) <= 2.0


def test_kernel_plans_decline_the_net():
    """K3/K7 (``plan_for``), K4/K6 (``collect_plan_for``) and K5/K8
    (``drqn_plan_for``) take no Soft MoE net: it runs the plain steps and
    the plain collect."""
    from port_bench.harness.program import _net
    from deepqlearning_tpu_torch.ops.cuda.fused_collect import (
        collect_plan_for)
    from deepqlearning_tpu_torch.ops.cuda.fused_drqn import drqn_plan_for
    from deepqlearning_tpu_torch.ops.cuda.fused_update import plan_for

    net = _net(_spec(torch.float32), _registry(), "cpu")
    assert plan_for(net) is None
    assert drqn_plan_for(net, 8, 32) is None
    for env in (dt.SimpleGridWorld(), dt.TestMDP((20, 20), 4, 6)):
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, 256, 32,
                                         device="cpu")
        assert collect_plan_for(env, net, buf) is None


def _moe_chain(num_actions, device="cpu"):
    """A narrow bf16 IMPALA trunk on 12x12x4 frames (12 -> 6 -> 3) under
    ``SoftMoE(8, 4, 1, 16)`` over its 9 positions and the final layer."""
    from port_bench.harness.registry import load_module

    stack = load_module(BENCH / "layers" / "ImpalaStack.py")
    return dt.Chain(dt.Activation(lambda x: x.to(torch.bfloat16)),
                    stack.program([4, 8], device),
                    stack.program([8, 8], device), dt.Activation(torch.relu),
                    dt.SoftMoE(8, 4, 1, 16, device=device), dt.Flatten(),
                    dt.Dense(9 * 16, num_actions, device=device))


def test_solve_runs_the_moe_net():
    """``DeepQLearningSolver.solve`` trains the narrow bf16 Soft MoE
    dueling net on TestMDP for a few iterations: U = 2 grouped plain
    updates, PER, an evaluation; it ends finite with bf16 leaves, the
    layer's among them."""
    mdp = dt.TestMDP((12, 12), 4, 6)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = dt.DeepQLearningSolver(
            qnetwork=_moe_chain(mdp.num_actions), max_steps=160,
            num_envs=16, train_freq=8, batch_size=8, buffer_size=256,
            train_start=64, learning_rate=1e-3, max_episode_length=6,
            double_q=True, dueling=True, prioritized_replay=True,
            target_update_freq=64, eval_freq=160, num_ep_eval=8,
            log_freq=160, save_freq=1 << 30, logdir=None, verbose=False,
            dtype="bfloat16", device="cpu",
            exploration_policy=dt.EpsGreedyPolicy(
                dt.LinearDecaySchedule(1.0, 0.1, 160)))
        policy = s.solve(mdp)
    finally:
        torch.set_num_threads(threads)
    leaves = policy.params
    assert {p.dtype for p in leaves.values()} == {torch.bfloat16}
    assert all(bool(torch.isfinite(p.float()).all())
               for p in leaves.values())
    moe = [m for m in policy.network.modules() if isinstance(m, dt.SoftMoE)]
    assert len(moe) == 1
    assert {k: tuple(v.shape) for k, v in leaves.items()
            if k.startswith("base.layers.4.")} == {
        "base.layers.4.phi": (8, 4), "base.layers.4.w": (4, 8, 16),
        "base.layers.4.b": (64,)}
    assert profiling.counter("model.soft_moe") > 0


def test_segment_puts_the_moe_calls_of_an_iteration():
    """An iteration at U = 8 makes 18 forwards (the collect's, the target
    net's over all U·B rows, and per update the online net's on s' and on
    s), each through the one Soft MoE layer: the eager segment puts
    ``segment.layer_calls.soft_moe`` of its route at 18, and the reader of
    ``segment.moe_calls`` reads it from the route ``port_bench segment``."""
    from types import SimpleNamespace

    from port_bench.harness.recorder import SEGMENT

    env = dt.TestMDP((12, 12), 4, 6)
    net = dt.create_dueling_network(_moe_chain(env.num_actions))
    cfg = dt.DQNConfig(num_envs=32, batch_size=8, buffer_size=256,
                       train_freq=4, train_start=64, max_episode_length=6,
                       target_update_freq=64, seed=1, dtype=torch.bfloat16)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, obs_dtype=cfg.dtype,
                                      device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 200),
                              env.discount)
    c = init_carry(env, net, buf, cfg, opt, "cpu")
    c = make_collect_graph(pop, c, cfg, env, buf, "moe populate")(c, 4)
    run = make_segment(it, c, cfg, env, buf, SEGMENT)
    c = run(c, 2)
    counters = profiling.snapshot()["counters"]
    assert counters["segment.layer_calls.soft_moe"][SEGMENT] == 18
    assert profiling.counter("model.soft_moe") == 4 + 2 * 18
    reader = _registry().metric("segment.moe_calls")
    assert reader.read(SimpleNamespace()) == 18
    profiling.reset()
    assert reader.read(SimpleNamespace()) is None


def test_moe_share_reads_the_layer_kernels_of_a_trace():
    """``metrics/moe.device_share.py``: the seconds of the kernels only the
    layer launches over the trace's busy seconds; the trunk's kernels, the
    shared ATen, K10 and cuBLAS ones do not count; None without a trace or
    without one of them."""
    from types import SimpleNamespace

    reader = _registry().metric("moe.device_share")
    conv = sorted(_registry().metric("conv.device_share").KERNELS)[0]
    assert not reader.KERNELS & _registry().metric(
        "conv.device_share").KERNELS
    mine = sorted(reader.KERNELS)
    by_kernel = {mine[0]: (17, 0.004), mine[-1]: (8, 0.001),
                 conv: (8, 0.02), "bias_act_kernel": (18, 0.005),
                 "at::native::vectorized_elementwise_kernel": (50, 0.04),
                 "": (40, 0.003)}
    ctx = SimpleNamespace(trace=dict(busy_s=0.1, by_kernel=by_kernel))
    assert reader.read(ctx) == pytest.approx(5.0)
    ctx.trace["by_kernel"] = {conv: (1, 0.01)}
    assert reader.read(ctx) is None
    assert reader.read(SimpleNamespace(trace=None)) is None


# --- the benchmark's check on a tiny Soft MoE cell -----------------------
@pytest.fixture
def moe_bench(tmp_path):
    """A copy of the benchmark folder with the tiny Soft MoE cell
    (``port_bench/tests/fixtures``) and a benchmark file that lists it."""
    from port_bench.harness.registry import Registry

    fixtures = BENCH / "tests" / "fixtures"
    dst = tmp_path / "port_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((fixtures / "BENCHMARK.json").read_text())
    name = "tiny_impala_moe"
    shutil.copy(fixtures / "configs" / f"{name}.json", dst / "configs")
    shutil.copy(fixtures / "workloads" / f"{name}.learner.json",
                dst / "workloads")
    bench["configs"].append(dict(bench["configs"][-1], name=name,
                                 file=f"port_bench/configs/{name}.json"))
    bench["workloads"].append({"name": f"{name}.learner", "config": name,
                               "traffic": "learner", "chips": 1,
                               "why": "a test"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return Registry(dst, path)


SEEDS = [2 ** 31 + 12345, 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_benchmark_check_reads_correct(moe_bench, seed):
    """``run_cell`` on the tiny Soft MoE cell (20x20x4 frames, stacks of
    8, ``SoftMoE(8, 4, 2, 16)``, 16 envs, U = 4 updates of 8, bf16) builds
    the port's loop from the layer files, runs it, follows it with the
    plain reference and reads ``correct`` with every number within its
    limit, in well under 20 s."""
    from port_bench.harness.bench import run_cell

    t0 = time.perf_counter()
    out = run_cell("tiny_impala_moe.learner", seed, 0.3, False, "cpu", t0,
                   moe_bench, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["counters"]["train.adam_plain"] > 0
    assert time.perf_counter() - t0 < 20.0


@pytest.mark.parametrize("seed", SEEDS)
def test_benchmark_check_catches_swapped_axes(moe_bench, seed,
                                              monkeypatch):
    """The same run with the planted fault in the port's layer (each
    softmax over the other's axis) reads ``correct`` false: the first
    gradient and the first update's priorities leave their limits."""
    from port_bench.harness.bench import run_cell

    monkeypatch.setattr(dt.SoftMoE, "_weights", staticmethod(swapped))
    out = run_cell("tiny_impala_moe.learner", seed, 0.3, False, "cpu",
                   time.perf_counter(), moe_bench, log=lambda s: None)
    assert not out["correct"]
    bad = {k for k, v in out["checks"].items() if not v["value"] <= v[
        "limit"]}
    assert {"grad_gap", "td1_gap"} <= bad, out["checks"]


# -------------------------------------------------------------------- card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layer's bf16 GEMMs with f32 "
                    "results (torch.bmm out_dtype) run only on CUDA")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("rows", [32, 256])
def test_layer_at_the_cells_shapes(card, rows):
    """``SoftMoE(32, 8, 1, 512)`` in bf16 at the cell's rows (a forward of
    32 samples, the target net's 256) on an 11x11x32 map: the output, the
    input gradient and every parameter's gradient within two bf16 units in
    the last place at the tensor's scale of the plain reference on the
    card (cuBLAS sums the f32 products in its own order and splits)."""
    part = _part()
    layer = part.program([32, 8, 1, 512], card)
    params = {f"s.{k}": v for k, v in layer.init(
        torch.Generator(device=card).manual_seed(3),
        torch.bfloat16).items()}
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(rows, 11, 11, 32, generator=gen,
                    device=card).relu().to(torch.bfloat16)
    gy = (1e-3 * torch.randn(rows, 121, 512, generator=gen,
                             device=card)).to(torch.bfloat16)
    ours, ref = _both(part, layer, params, x, gy, [32, 8, 1, 512])
    for a, b in zip(ours, ref):
        assert _ulps_apart(a, b) <= 2.0


@pytest.mark.card
def test_layer_in_a_cuda_graph(card):
    """Forward and backward captured as a CUDA graph and replayed five
    times: every replay gives the warm-up's bits."""
    part = _part()
    layer = part.program([32, 8, 1, 512], card)
    params = layer.init(torch.Generator(device=card).manual_seed(3),
                        torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(32, 11, 11, 32, generator=gen,
                    device=card).relu().to(torch.bfloat16)
    gy = torch.randn(32, 121, 512, generator=gen, device=card).to(
        torch.bfloat16)

    def step():
        pp = {k: v.detach().requires_grad_() for k, v in params.items()}
        xx = x.detach().requires_grad_()
        y, _ = layer.apply(pp, xx)
        return [y.detach()] + list(torch.autograd.grad(
            y, [xx] + list(pp.values()), gy))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm = step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, warm))
