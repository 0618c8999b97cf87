"""The small kernels' times on one CUDA GPU, by their device events.

    python3 -m deepqlearning_tpu_torch.ops.cuda.kernel_events [--calls N]

A wrapper timed with CUDA events around back-to-back calls measures the
kernel only when the device is slower than the host's enqueue of the next
call. K1 (``td_loss_kernel``), K2 (``tree_sample_kernel``), K4
(``fc_kernel``), K6 (``fc_rnn_kernel``), K7 and K8 (the grads-emitting
sub-updates of the data-parallel routes) and K9 (``adam_kernel``, the plain
steps' Adam) are short, so this times each by the device's own events
under ``torch.profiler`` (the kernel's launches alone, matched by name)
beside the CUDA-event time of its wrapper, at the main paths' shapes: K1
at B = 512, at the ungrouped loop's B = 32 and at B = 4096 (A = 4,
double-Q, int64 actions as the replay gives them), K2 on 2^20 leaves with
16384 draws, K6 at 16384 envs with ``Chain(LSTM(2, 32), Dense(32, 4))``
(and on CartPole and MountainCar), K4 at 131072 envs on each env it steps
(:func:`collect_cases`), K7 (``fu_group_kernel`` at U = 1) at the DP
headline's B = 512 with the dueling 2-64-64-4 net and double-Q, K8
(``dr_group_kernel`` at U = 1) at the DP DRQN's B = 512, T = 8 with the
LSTM32 net and double-Q, K9 at the benchmark's two configurations
(:func:`adam_cases`), K10's forward and backward at the cells' epilogues
(:func:`bias_act_cases`), K11 (``dr_target_kernel``, the DRQN target's
Q(s')) at the DRQN cell's 2048 windows and three other nets
(:func:`drqn_target_cases`), and K1 and K2 on the image-observation DQN's
route (:func:`conv_cases`). Beside K1 it times an empty kernel launched as
K1 is (``td_kernel.cu::empty_kernel``, K1's block, or its cluster of
blocks past 512 rows): the launch floor under K1.
Prints the card's name and power limit, then one JSON line.

It uses only the wrappers' call signatures of the parent commits (and
skips the empty kernel, the envs, K9, K10 and K11 where a checkout lacks
them),
so the file can be copied into another checkout of the port (the same
path) to time that checkout's kernels the same way, in the same call.
"""
import argparse
import json
import subprocess
import sys


def kernel_symbol(name):
    """A device event's kernel name without return type, template
    arguments and parameters: ``void td_loss_kernel<4, 4, long long>(float
    const*, ...)`` and ``td_loss_kernel(float const*, ...)`` are both
    ``td_loss_kernel``."""
    cut = [i for i in (name.find("("), name.find("<")) if i >= 0]
    return name[:min(cut, default=len(name))].split(" ")[-1]


def device_event_ms(torch, fn, symbol, calls=50):
    """``(device ms per launch, launches per call)`` of the kernel named
    ``symbol`` over ``calls`` calls of ``fn`` under ``torch.profiler``;
    only the device's events of that name count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and kernel_symbol(e.name) == symbol):
            us += e.time_range.elapsed_us()
            n += 1
    if n == 0:
        raise RuntimeError(f"the profiler saw no launch of {symbol}")
    return 1e-3 * us / n, n / calls


def wrapper_ms(torch, fn, calls=200):
    """Mean time of ``fn`` by CUDA events around ``calls`` back-to-back
    calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def cases(torch, dev):
    """``{name: (kernel symbol, call)}`` at the main paths' shapes, inputs
    from fixed seeds."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, Flatten, create_dueling_network)
    from deepqlearning_tpu_torch.envs.gridworld import SimpleGridWorld
    from deepqlearning_tpu_torch.ops import sumtree
    from deepqlearning_tpu_torch.ops.cuda import (
        fused_collect as fc, fused_drqn as fd, fused_update as fu,
        td_kernel as tk, tree_sample as ts)

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev)
    out = {}
    for B in (512, 32, 4096):
        args = (rnd(B, 4), rnd(B, 4), rnd(B, 4),
                torch.randint(0, 4, (B,), generator=g, device=dev), rnd(B),
                (uni(B) < 0.1).float(), uni(B) + 0.5, 0.95, 0.6, 1e-3, True)
        out[f"K1 td_loss B={B}"] = (
            "td_loss_kernel", lambda args=args: tk.td_loss_cuda(*args))
        if hasattr(tk, "empty_cuda"):
            out[f"K1 floor: empty kernel, K1's block B={B}"] = (
                "empty_kernel", lambda B=B: tk.empty_cuda(dev, B))
    tree = sumtree.init_tree(1 << 20, dev)
    sumtree.set_priorities_slice(tree, 0, uni(1 << 20) + 0.01)
    mass = sumtree.stratified_mass(tree, uni(16384))
    out["K2 tree_sample 2^20/16384"] = (
        "tree_sample_kernel", lambda: ts.tree_sample_cuda(tree, mass))
    out.update(conv_cases(torch, dev))
    env, E = SimpleGridWorld(), 16384
    net = Chain(LSTM(2, 32, device=dev), Dense(32, 4, device=dev))
    plan = fc.collect_plan_for(env, net, None)
    params = net.init(g)
    st, obs = env.reset_batch(E, torch.Generator(device=dev).manual_seed(2))
    ins = dict(obs=obs, state=st,
               ep_step=torch.randint(0, 100, (E,), generator=g, device=dev,
                                     dtype=torch.int32),
               ep_ret=rnd(E), u=uni(6, E), eps=0.3, max_episode_length=100,
               nstate=rnd(E, plan.state_width) * 0.5)
    out["K6 fused_collect (recurrent) LSTM32 E=16384"] = (
        "fc_rnn_kernel",
        lambda: fc.fused_collect_rnn_cuda(env, plan, params, **ins))
    out.update(collect_cases(torch, dev, g))
    B = 512
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 64, torch.tanh, device=dev),
        Dense(64, 64, torch.tanh, device=dev), Dense(64, 4, device=dev)))
    k7_plan, k7_params = fu.plan_for(net), net.init(g)
    k7_data = dict(obs_s=uni(B, 2) * 10, obs_sp=uni(B, 2) * 10,
                   action=torch.randint(0, 4, (B,), generator=g, device=dev),
                   reward=rnd(B), done=(uni(B) < 0.05).float(),
                   weights=uni(B) + 0.5, q_sp_tgt=rnd(B, 4))
    out["K7 fused_grads U=1 DP headline B=512"] = (
        "fu_group_kernel", lambda: fu.fused_grads_cuda(
            k7_plan, k7_params, **k7_data, gamma=0.95, double_q=True,
            alpha=0.6, eps=1e-3))
    T = 8
    lstm = Chain(LSTM(2, 32, device=dev), Dense(32, 4, device=dev))
    k8_plan, k8_params = fd.drqn_plan_for(lstm, T, B, True), lstm.init(g)
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
    k8_data = dict(
        obs=uni(B, T, 2) * 10, nobs=uni(B, T, 2) * 10,
        action=torch.randint(0, 4, (B, T), generator=g, device=dev),
        reward=rnd(B, T), done=(uni(B, T) < 0.1).float(),
        mask=(torch.arange(T, device=dev)[None] < lens[:, None]).float(),
        q_sp_tgt=rnd(B, T, 4))
    out["K8 fused_drqn_grads U=1 DP DRQN LSTM32 B=512 T=8"] = (
        "dr_group_kernel", lambda: fd.fused_drqn_grads_cuda(
            k8_plan, k8_params, **k8_data, gamma=0.95, double_q=True))
    out.update(adam_cases(torch, dev, g))
    out.update(bias_act_cases(torch, dev, g))
    out.update(drqn_target_cases(torch, dev, g))
    return out


def adam_nets(torch, dev):
    """``{name: (network, dtype, learning rate)}``: the benchmark's two
    configurations (``port_bench/configs/``), the dueling 2-64-64-4 tanh
    MLP in f32 (12 tensors, 9,029 parameters) and the Nature DQN trunk
    with 512-wide dueling streams in bf16 (14 tensors, 3,292,837)."""
    from deepqlearning_tpu_torch import (
        Activation, Chain, Conv2D, Dense, Flatten, create_dueling_network)

    relu, tanh = torch.relu, torch.tanh
    mlp = create_dueling_network(Chain(
        Flatten(), Dense(2, 64, tanh, device=dev),
        Dense(64, 64, tanh, device=dev), Dense(64, 4, device=dev)))
    nature = create_dueling_network(Chain(
        Activation(lambda x: x.to(torch.bfloat16)),
        Conv2D(4, 32, (8, 8), (4, 4), "VALID", relu, device=dev),
        Conv2D(32, 64, (4, 4), (2, 2), "VALID", relu, device=dev),
        Conv2D(64, 64, (3, 3), (1, 1), "VALID", relu, device=dev), Flatten(),
        Dense(3136, 512, relu, device=dev), Dense(512, 4, device=dev)))
    return {"grid_dueling_mlp f32": (mlp, torch.float32, 1e-4),
            "nature_dueling_dqn bf16": (nature, torch.bfloat16, 6.25e-5)}


def adam_inputs(torch, dev, g, name):
    """``(optimizer, grads, state, params)`` of K9 at :func:`adam_nets`'
    ``name``: fresh parameters and Adam state, gradients of standard
    deviation 0.01."""
    from deepqlearning_tpu_torch.learner.train_step import make_optimizer

    net, dtype, lr = adam_nets(torch, dev)[name]
    params = {k: v.detach().clone() for k, v in net.init(g, dtype).items()}
    opt = make_optimizer(lr)
    grads = {k: (1e-2 * torch.randn(p.shape, generator=g, device=dev)).to(
        dtype) for k, p in params.items()}
    return opt, grads, opt.init(params), params


def adam_cases(torch, dev, g):
    """K9 (``adam_kernel``) at both :func:`adam_nets`, each call one Adam
    step in place. Only where the checkout has K9."""
    try:
        from deepqlearning_tpu_torch.ops.cuda import adam
    except ImportError:
        return {}
    out = {}
    for name in adam_nets(torch, dev):
        ins = adam_inputs(torch, dev, g, name)
        out[f"K9 adam_update {name}"] = (
            "adam_kernel", lambda ins=ins: adam.adam_update(*ins))
    return out


def bias_act_shapes():
    """``{name: (product shape, product dtype, bias and output dtype,
    activation)}``: K10's epilogues on the cells' main shapes (the IMPALA
    trunk's first two stacks and the Nature trunk's first conv at batch 32,
    the Nature actor's first conv at 2048 envs, a 512-wide Nature stream,
    grid_mlp's target forward over 16384 rows)."""
    bf16, f32 = "bfloat16", "float32"
    return {
        "IMPALA 32x84x84x16 relu": ((32, 84, 84, 16), bf16, bf16, "relu"),
        "IMPALA 32x42x42x32 relu": ((32, 42, 42, 32), bf16, bf16, "relu"),
        "Nature 32x20x20x32 relu": ((32, 20, 20, 32), bf16, bf16, "relu"),
        "Nature 2048x20x20x32 relu": ((2048, 20, 20, 32), bf16, bf16,
                                      "relu"),
        "Nature stream 32x512 relu": ((32, 512), f32, bf16, "relu"),
        "grid_mlp 16384x64 tanh": ((16384, 64), f32, f32, "tanh"),
    }


def bias_act_inputs(torch, dev, g, name):
    """``(y, b, cotangent, activation, output dtype)`` of
    :func:`bias_act_shapes`' ``name``: a product of standard deviation 3,
    a bias and a cotangent of 1."""
    shape, yd, od, act = bias_act_shapes()[name]
    yd, od = getattr(torch, yd), getattr(torch, od)
    y = (3 * torch.randn(shape, generator=g, device=dev)).to(yd)
    b = torch.randn(shape[-1], generator=g, device=dev).to(od)
    cot = torch.randn(shape, generator=g, device=dev).to(od)
    return y, b, cot, getattr(torch, act), od


def bias_act_cases(torch, dev, g):
    """K10 at :func:`bias_act_shapes`: the forward (``bias_act_kernel``,
    each call one forward) and the backward (``bias_act_grad_kernel``,
    each call a forward and its backward). Only where the checkout has
    K10."""
    try:
        from deepqlearning_tpu_torch.ops.cuda import bias_act as ba
    except ImportError:
        return {}
    out = {}
    for name in bias_act_shapes():
        y, b, cot, act, od = bias_act_inputs(torch, dev, g, name)
        yg, bg = y.clone().requires_grad_(), b.clone().requires_grad_()

        def grad(yg=yg, bg=bg, cot=cot, act=act, od=od):
            torch.autograd.grad(ba.bias_act(yg, bg, act, od), (yg, bg), cot)

        out[f"K10 bias_act {name}"] = (
            "bias_act_kernel", lambda y=y, b=b, act=act, od=od:
            ba.bias_act(y, b, act, od))
        out[f"K10 bias_act_grad {name}"] = ("bias_act_grad_kernel", grad)
    return out


def drqn_target_nets(torch, dev):
    """``{name: (network, N windows, T)}``: the networks K11 is held to its
    twin on: ``grid_drqn.learner``'s (dueling LSTM(2, 32), A = 4) at the
    cell's 2048 windows of 8 steps; a GRU16 with a Dense layer before it
    and a plain head on an odd window count (a ragged last tile); a
    dueling GRU with two-layer heads; an LSTM over a long trace."""
    from deepqlearning_tpu_torch import (
        GRU, LSTM, Chain, Dense, create_dueling_network)

    return {
        "LSTM32 dueling (grid_drqn.learner)": (create_dueling_network(Chain(
            LSTM(2, 32, device=dev), Dense(32, 4, device=dev))), 2048, 8),
        "GRU16 after Dense, plain head": (Chain(
            Dense(2, 16, torch.tanh, device=dev), GRU(16, 16, device=dev),
            Dense(16, 3, device=dev)), 1001, 8),
        "GRU32 dueling, two-layer heads": (create_dueling_network(Chain(
            Dense(2, 16, torch.tanh, device=dev), GRU(16, 32, device=dev),
            Dense(32, 32, torch.relu, device=dev),
            Dense(32, 4, device=dev))), 513, 8),
        "LSTM32 long trace": (Chain(LSTM(2, 32, device=dev),
                                    Dense(32, 4, device=dev)), 67, 64),
    }


def drqn_target_inputs(torch, dev, g, name):
    """``(plan, network, params, next_obs)`` of :func:`drqn_target_nets`'
    ``name``: fresh parameters, next obs uniform on [0, 10) (the grid's
    coordinates)."""
    from deepqlearning_tpu_torch.ops.cuda import fused_drqn as fd

    net, N, T = drqn_target_nets(torch, dev)[name]
    plan = fd.drqn_plan_for(net, T, N)
    nobs = 10 * torch.rand(N, T, plan.in_dim, generator=g, device=dev)
    return plan, net, net.init(g), nobs


def drqn_target_cases(torch, dev, g):
    """K11 (``dr_target_kernel``) at :func:`drqn_target_nets`. Only where
    the checkout has K11."""
    from deepqlearning_tpu_torch.ops.cuda import fused_drqn as fd

    if not hasattr(fd, "drqn_target_q_cuda"):
        return {}
    out = {}
    for name in drqn_target_nets(torch, dev):
        plan, _, params, nobs = drqn_target_inputs(torch, dev, g, name)
        out[f"K11 drqn_target_q {name}"] = (
            "dr_target_kernel", lambda p=(plan, params, nobs):
            fd.drqn_target_q_cuda(*p))
    return out


def conv_cases(torch, dev):
    """K1 and K2 at the image-observation DQN's shapes
    (``examples/image_conv_dqn.py``): K1 at B = 512, A = 4 on the Q values
    of its bf16 conv net cast to f32 (s from one parameter set, s' online
    and target from two), K2 on 2^15 leaves with 2048 draws in 4
    sub-batches; from a generator of their own. Only where the checkout has
    ``Conv2D`` (K2's case too, to keep the pair together)."""
    import deepqlearning_tpu_torch as pkg
    from deepqlearning_tpu_torch.ops import sumtree
    from deepqlearning_tpu_torch.ops.cuda import td_kernel as tk
    from deepqlearning_tpu_torch.ops.cuda import tree_sample as ts

    if not hasattr(pkg, "Conv2D"):
        return {}
    g = torch.Generator(device=dev).manual_seed(3)
    args = conv_k1_inputs(torch, dev, g)
    tree = sumtree.init_tree(1 << 15, dev)
    sumtree.set_priorities_slice(
        tree, 0, torch.rand(1 << 15, generator=g, device=dev) + 0.01)
    mass = sumtree.stratified_mass(
        tree, torch.rand(2048, generator=g, device=dev))
    return {
        "K1 td_loss conv route B=512": (
            "td_loss_kernel", lambda: tk.td_loss_cuda(
                *args, 0.95, 0.6, 1e-3, True)),
        "K2 tree_sample conv route 2^15/2048 in 4": (
            "tree_sample_kernel", lambda: ts.tree_sample_cuda(tree, mass, 4)),
    }


def conv_net(torch, dev, bf16=True, A=4):
    """``examples/image_conv_dqn.py``'s dueling conv net on (20, 20, 4)
    obs (with its leading bf16 cast when ``bf16``), on ``dev``."""
    from deepqlearning_tpu_torch import (
        Activation, Chain, Conv2D, Dense, Flatten, create_dueling_network)

    relu = torch.relu
    layers = [Conv2D(4, 32, (3, 3), (1, 1), "SAME", relu),
              Conv2D(32, 64, (3, 3), (2, 2), "SAME", relu),
              Conv2D(64, 128, (3, 3), (2, 2), "SAME", relu), Flatten(),
              Dense(5 * 5 * 128, 512, relu), Dense(512, A)]
    if bf16:
        layers.insert(0, Activation(lambda x: x.to(torch.bfloat16)))
    return create_dueling_network(Chain(*layers)).to(dev)


def conv_k1_inputs(torch, dev, g, B=512):
    """K1's inputs on the conv route: Q(s), Q(s') online and Q(s') target
    of the bf16 conv net (two parameter sets) cast to f32, int64 actions,
    reward, done and IS weights."""
    net = conv_net(torch, dev)
    online = net.init(g, torch.bfloat16)
    online = {k: v.clone() for k, v in online.items()}
    target = net.init(g, torch.bfloat16)
    obs = torch.rand(B, 20, 20, 4, generator=g, device=dev)
    nobs = torch.rand(B, 20, 20, 4, generator=g, device=dev)
    with torch.no_grad():
        q = net.apply(online, obs)[0].float()
        q_sp = net.apply(online, nobs)[0].float()
        q_tgt = net.apply(target, nobs)[0].float()
    return (q, q_sp, q_tgt,
            torch.randint(0, 4, (B,), generator=g, device=dev),
            torch.randn(B, generator=g, device=dev),
            (torch.rand(B, generator=g, device=dev) < 0.1).float(),
            torch.rand(B, generator=g, device=dev) + 0.5)


def _collect_nets(torch, dev, no, A):
    """The dueling 64-64 tanh head K4 serves in the loops on an env with
    ``no`` inputs and ``A`` actions."""
    from deepqlearning_tpu_torch import (
        Chain, Dense, Flatten, create_dueling_network)

    return create_dueling_network(Chain(
        Flatten(), Dense(no, 64, torch.tanh, device=dev),
        Dense(64, 64, torch.tanh, device=dev), Dense(64, A, device=dev)))


def collect_cases(torch, dev, g):
    """K4 at E = 131072 on each env it steps, with the dueling 64-64 tanh
    head on the env's obs (SimpleGridWorld: the headline's), and K6 at
    16384 envs on CartPole (``LSTM(4, 32) + Dense(32, 2)``) and MountainCar
    (a dueling GRU16 head); states from each env's reset. Only the envs of
    this checkout."""
    import deepqlearning_tpu_torch as pkg
    from deepqlearning_tpu_torch.ops.cuda import fused_collect as fc

    out = {}
    for name in ("SimpleGridWorld", "CartPole", "MountainCar"):
        if not hasattr(pkg, name):
            continue
        env = getattr(pkg, name)()
        E = 131072
        net = _collect_nets(torch, dev, env.obs_shape[0], env.num_actions)
        plan = fc.collect_plan_for(env, net, None)
        rows = getattr(plan, "n_uniforms", 6)
        st, obs = env.reset_batch(E, torch.Generator(device=dev)
                                  .manual_seed(2))
        ins = dict(obs=obs, state=st,
                   ep_step=torch.randint(0, 100, (E,), generator=g,
                                         device=dev, dtype=torch.int32),
                   ep_ret=torch.randn(E, generator=g, device=dev),
                   u=torch.rand(rows, E, generator=g, device=dev), eps=0.3,
                   max_episode_length=100)
        params = net.init(g)
        out[f"K4 fused_collect {name} E=131072"] = (
            "fc_kernel", lambda env=env, plan=plan, params=params, ins=ins:
            fc.fused_collect_cuda(env, plan, params, **ins))
        if name == "SimpleGridWorld":
            continue
        from deepqlearning_tpu_torch import (
            GRU, LSTM, Chain, Dense, DuelingNetwork)

        no, A, E = env.obs_shape[0], env.num_actions, 16384
        net = (Chain(LSTM(no, 32, device=dev), Dense(32, A, device=dev))
               if name == "CartPole" else DuelingNetwork(
                   Chain(GRU(no, 16, device=dev)),
                   Chain(Dense(16, 32, torch.tanh, device=dev),
                         Dense(32, 1, device=dev)),
                   Chain(Dense(16, 32, torch.tanh, device=dev),
                         Dense(32, A, device=dev))))
        plan = fc.collect_plan_for(env, net, None)
        st, obs = env.reset_batch(E, torch.Generator(device=dev)
                                  .manual_seed(2))
        ins = dict(obs=obs, state=st,
                   ep_step=torch.randint(0, 100, (E,), generator=g,
                                         device=dev, dtype=torch.int32),
                   ep_ret=torch.randn(E, generator=g, device=dev),
                   u=torch.rand(plan.n_uniforms, E, generator=g, device=dev),
                   eps=0.3, max_episode_length=100,
                   nstate=torch.randn(E, plan.state_width, generator=g,
                                      device=dev) * 0.5)
        params = net.init(g)
        cell = "LSTM32" if name == "CartPole" else "dueling GRU16"
        out[f"K6 fused_collect (recurrent) {name} {cell} E=16384"] = (
            "fc_rnn_kernel", lambda env=env, plan=plan, params=params,
            ins=ins: fc.fused_collect_rnn_cuda(env, plan, params, **ins))
    return out


def measure(torch, dev, calls=50):
    """``{case: {device_ms, launches_per_call, wrapper_ms}}`` for every
    case of :func:`cases`."""
    res = {}
    for name, (symbol, fn) in cases(torch, dev).items():
        ms, per_call = device_event_ms(torch, fn, symbol, calls)
        res[name] = dict(kernel=symbol, device_ms=ms,
                         launches_per_call=per_call,
                         wrapper_ms=wrapper_ms(torch, fn))
    return res


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_events: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(measure(torch, torch.device("cuda:0"), args.calls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
