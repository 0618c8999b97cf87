"""The IMPALA ResNet trunk (Espeholt et al. 2018, Figure 3, right) on the
port, on the CPU: ``MaxPool2D`` against ``jax.lax.reduce_window`` (max
from ``-inf``), one stack (``Conv2D``, ``MaxPool2D``, two ``Residual``
blocks) and the whole dueling net against the benchmark's plain reference
(``port_bench/layers/ImpalaStack.py``, ``port_bench/reference/nets.py``),
the kernel plans declining the net, a few iterations of ``solve``, and the
benchmark's check of a tiny IMPALA cell reading ``correct``."""
import json
import math
import shutil
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.models.chain import same_pads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _registry():
    from port_bench.harness.registry import Registry

    return Registry()


def _stack_part():
    from port_bench.harness.registry import load_module

    return load_module(BENCH / "layers" / "ImpalaStack.py")


# --- MaxPool2D -----------------------------------------------------------
@pytest.mark.parametrize("n,k,s,padding", [
    (84, 3, 2, "SAME"), (42, 3, 2, "SAME"), (21, 3, 2, "SAME"),
    (13, 3, 2, "SAME"), (84, 3, 2, "VALID"), (21, 3, 2, "VALID"),
    (13, 3, 2, "VALID"), (9, 2, 1, "SAME"), (10, 3, 3, "SAME")])
def test_maxpool_matches_lax_reduce_window(n, k, s, padding):
    """Forward in f32 and bf16 and the input gradient in f32 (no ties:
    both send a window's gradient to its first largest element) against
    ``lax.reduce_window(x, -inf, lax.max, ...)``; at 84 and 42 lax's SAME
    pads are (0, 1), which PyTorch's symmetric ``padding`` cannot give."""
    rng = np.random.default_rng(n * 100 + k * 10 + s)
    x = rng.normal(size=(2, n, n + 1, 3)).astype(np.float32)
    pool = dt.MaxPool2D((k, k), (s, s), padding)

    def ref(a):
        return jax.lax.reduce_window(a, -jnp.inf, jax.lax.max, (1, k, k, 1),
                                     (1, s, s, 1), padding)

    want = np.asarray(ref(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = pool(xt)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.detach().numpy(), want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = np.asarray(ref(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    yb = pool(xb)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_array_equal(yb.float().numpy(), wb)
    g = rng.normal(size=want.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(ref, jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(g)[0]))
    if padding == "SAME" and n in (84, 42):
        assert same_pads(n, k, s) == (0, 1)


def test_maxpool_refuses_other_padding():
    with pytest.raises(ValueError, match="padding"):
        dt.MaxPool2D((3, 3), (2, 2), "FULL")


# --- one stack against the plain reference -------------------------------
def _ulps_apart(a, b):
    """The largest gap of two bf16 tensors in units of bf16's last place at
    the scale of the larger tensor's largest magnitude."""
    a, b = a.detach().float(), b.detach().float()
    scale = max(float(a.abs().max()), float(b.abs().max()))
    _, e = math.frexp(scale)
    return float((a - b).abs().max()) / 2.0 ** (e - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_matches_the_reference(dtype):
    """``ImpalaStack(4, 8)`` at 20x20 frames: the output, the input
    gradient and every weight gradient of the port's stack against the
    plain forward of ``port_bench/layers/ImpalaStack.py`` (f32 products on
    f32 copies, each convolution rounded to the dtype before its bias, the
    max exact, the skip add rounded), bit for bit in f32; in bf16 within
    two units in the last place at the tensor's scale, since the CPU's bf16
    convolution sums apart from the reference's f32 one; and the stack's
    shape, multiply-adds and parameters as the file counts them."""
    from torch.func import functional_call

    from port_bench.reference.nets import Precision

    part = _stack_part()
    args = [4, 8]
    g = torch.Generator().manual_seed(3)
    stack = part.program(args, "cpu")
    params = {f"s.{k}": v for k, v in stack.init(g, dtype).items()}
    assert part.n_params(args) == sum(v.numel() for v in params.values())
    assert sorted(params) == sorted(
        ["s.layers.0.w", "s.layers.0.b"] + [
            f"s.layers.{i}.inner.layers.{j}.{p}"
            for i, j in part.CONVS for p in "wb"])
    x = torch.randn(5, 20, 20, 4, generator=g).to(dtype)
    outs = []
    for fwd in (lambda xx, pp: functional_call(
                    stack, {k[2:]: v for k, v in pp.items()}, (xx,)),
                lambda xx, pp: part.forward(xx, pp, "s", args, Precision())):
        xx = x.clone().requires_grad_()
        pp = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
        y = fwd(xx, pp)
        gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            4)).to(dtype)
        outs.append([y] + list(torch.autograd.grad(
            y, [xx] + list(pp.values()), gy)))
    assert tuple(outs[0][0].shape[1:]) == part.out_shape((20, 20, 4), args)
    assert outs[0][0].dtype == dtype
    for a, b in zip(*outs):
        if dtype == torch.float32:
            assert torch.equal(a, b)
        else:
            assert _ulps_apart(a, b) <= 2.0
    assert part.macs((20, 20, 4), args) == 20 * 20 * 9 * 4 * 8 + 4 * (
        10 * 10 * 9 * 8 * 8)
    assert part.obs_macs((20, 20, 4), args) == 20 * 20 * 9 * 4 * 8


# --- the whole dueling net -------------------------------------------------
def _spec(dtype):
    layers = [["ImpalaStack", 4, 16], ["ImpalaStack", 16, 32],
              ["ImpalaStack", 32, 32], ["ReLU"], ["Flatten"],
              ["Dense", 3 * 3 * 32, 64, "relu"], ["Dense", 64, 4, None]]
    if dtype == torch.bfloat16:
        layers.insert(0, ["Cast", "bfloat16"])
    return {"layers": layers, "dueling": True}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dueling_net_matches_the_reference_net(dtype):
    """The IMPALA dueling net at 20x20x4 frames with stacks of 16, 32 and
    32 channels (20 -> 10 -> 5 -> 3): the port's Q values on seeded
    weights against ``reference.nets.Net``'s from the same parameter dict,
    bit for bit in f32 and within two bf16 units in the last place in bf16;
    the parameter count and the forward's multiply-adds as the reference
    counts them."""
    from port_bench.harness.program import _net
    from port_bench.reference.nets import Net

    reg = _registry()
    spec = _spec(dtype)
    net = _net(spec, reg, "cpu")
    params = net.init(torch.Generator().manual_seed(11), dtype)
    ref = Net(spec, reg, (20, 20, 4))
    assert ref.n_params() == sum(v.numel() for v in params.values())
    base, val, adv = ref.macs()
    assert sum(base) == sum(_stack_part().macs(s, a) for s, a in (
        ((20, 20, 4), [4, 16]), ((10, 10, 16), [16, 32]),
        ((5, 5, 32), [32, 32])))
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
    """K3/K7 (``plan_for``), K4/K6 (``collect_plan_for``, on an env they
    step and on TestMDP) and K5/K8 (``drqn_plan_for``) take no IMPALA net:
    it runs the plain steps and the plain collect."""
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


def test_solve_runs_the_impala_net():
    """``DeepQLearningSolver.solve`` trains a narrow bf16 IMPALA dueling net
    on TestMDP's 12x12x4 frames for a few iterations: U = 2 grouped plain
    updates, PER, an evaluation; it ends finite with bf16 leaves."""
    mdp = dt.TestMDP((12, 12), 4, 6)
    part = _stack_part()
    relu = torch.relu
    model = dt.Chain(dt.Activation(lambda x: x.to(torch.bfloat16)),
                     part.program([4, 8], "cpu"), part.program([8, 8], "cpu"),
                     dt.Activation(relu), dt.Flatten(),
                     dt.Dense(3 * 3 * 8, 16, relu),
                     dt.Dense(16, mdp.num_actions))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = dt.DeepQLearningSolver(
            qnetwork=model, max_steps=160, num_envs=16, train_freq=8,
            batch_size=8, buffer_size=256, train_start=64,
            learning_rate=1e-3, max_episode_length=6, double_q=True,
            dueling=True, prioritized_replay=True, target_update_freq=64,
            eval_freq=160, num_ep_eval=8, log_freq=160, save_freq=1 << 30,
            logdir=None, verbose=False, dtype="bfloat16", device="cpu",
            exploration_policy=dt.EpsGreedyPolicy(
                dt.LinearDecaySchedule(1.0, 0.1, 160)))
        policy = s.solve(mdp)
    finally:
        torch.set_num_threads(threads)
    leaves = list(policy.params.values())
    assert {p.dtype for p in leaves} == {torch.bfloat16}
    assert all(bool(torch.isfinite(p.float()).all()) for p in leaves)
    assert any(isinstance(m, dt.MaxPool2D) for m in policy.network.modules())


# --- the benchmark's check on a tiny IMPALA cell -------------------------
@pytest.fixture
def impala_bench(tmp_path):
    """A copy of the benchmark folder with the tiny IMPALA cells
    (``port_bench/tests/fixtures``) and a benchmark file that lists them."""
    from port_bench.harness.registry import Registry

    fixtures = BENCH / "tests" / "fixtures"
    dst = tmp_path / "port_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((fixtures / "BENCHMARK.json").read_text())
    for name in ("tiny_impala", "tiny_impala32"):
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


@pytest.mark.parametrize("cell", ["tiny_impala.learner",
                                  "tiny_impala32.learner"])
def test_benchmark_check_reads_correct(impala_bench, cell):
    """``run_cell`` on a tiny IMPALA cell (20x20x4 frames, stacks of 8, 16
    envs, U = 4 updates of 8; bf16 and f32) builds the port's loop from the
    layer files, runs it, follows it with the plain reference and reads
    ``correct`` with every number within its limit, in well under 20 s."""
    from port_bench.harness.bench import run_cell

    t0 = time.perf_counter()
    out = run_cell(cell, 2 ** 31 + 12345, 0.3, False, "cpu", t0,
                   impala_bench, log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "prio_gap", "td1_gap", "rows_bad"}
    assert out["counters"]["train.adam_plain"] > 0
    assert time.perf_counter() - t0 < 20.0


def test_conv_share_reads_the_conv_kernels_of_a_trace():
    """``metrics/conv.device_share.py``: the convolution kernels' seconds
    (a listed symbol, or cuDNN's mangled cutlass convolution) over the
    trace's busy seconds; other kernels do not count; None without a trace
    or without a convolution."""
    from types import SimpleNamespace

    reader = _registry().metric("conv.device_share")
    fprop = sorted(k for k in reader.KERNELS if "_fprop_" in k)[0]
    by_kernel = {
        fprop: (8, 0.02),
        "cudnn::engines_precompiled::nhwcToNchwKernel": (4, 0.005),
        reader.MANGLED + "INS1_11threadblock22ImplicitGemmMultistage": (
            2, 0.005),
        "at::native::vectorized_elementwise_kernel": (50, 0.04),
        "cutlass::Kernel2": (3, 0.01)}
    ctx = SimpleNamespace(trace=dict(busy_s=0.1, by_kernel=by_kernel))
    assert reader.read(ctx) == pytest.approx(30.0)
    ctx.trace["by_kernel"] = {"adam_kernel": (1, 0.01)}
    assert reader.read(ctx) is None
    assert reader.read(SimpleNamespace(trace=None)) is None
