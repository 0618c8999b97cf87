"""The harness's work counts against hand counts."""
import json

import pytest

from conftest import FOLDER


def _conf(name):
    return json.loads((FOLDER / "configs" / f"{name}.json").read_text())


def _net(c):
    from port_bench.harness.registry import Registry
    from port_bench.reference.nets import Net

    return Net(c["net"], Registry(), c["env"]["obs_shape"])


def test_nature_dueling_forward():
    """84x84x4 frames: the convolutions 20x20x(8x8x4)x32, 9x9x(4x4x32)x64
    and 7x7x(3x3x64)x64 multiply-adds, 15.47 MFLOP; the dueling heads
    3136x512 twice, 512x4 and 512x1, 6.43 MFLOP; 21.90 MFLOP a sample."""
    from port_bench.harness import work

    c = _conf("nature_dueling_dqn")
    net = _net(c)
    trunk, val, adv = net.macs()
    assert trunk == [20 * 20 * 8 * 8 * 4 * 32, 9 * 9 * 4 * 4 * 32 * 64,
                     7 * 7 * 3 * 3 * 64 * 64]
    assert 2 * sum(trunk) == 15_474_688
    assert 2 * (sum(val) + sum(adv)) == 2 * (2 * 3136 * 512 + 512 * 5)
    assert work.forward_flops(net) == pytest.approx(21.90e6, rel=1e-3)
    assert work.first_layer_flops(net) == 2 * trunk[0]
    assert net.num_actions == 4 and not net.fused_collect()
    assert net.n_params() == (8 * 8 * 4 * 32 + 32 + 4 * 4 * 32 * 64 + 64
                                + 3 * 3 * 64 * 64 + 64 + 2 * (3136 * 512
                                                              + 512)
                                + 512 * 4 + 4 + 512 + 1)


def test_headline_k3_work():
    """K3 at the headline (U = 32, B = 512, 2-64-64-4 dueling, double-Q):
    2·U·B·(macs·2 + macs + macs - first) FLOPs, macs = 8768 per row and
    first = 2·64 + 2·64 (both streams' first layers read the obs), as
    ``chip_smoke.py::_dense_update_flops`` counts them."""
    from types import SimpleNamespace

    from port_bench.harness import work
    from port_bench.harness.registry import Registry

    reg = Registry()
    c = _conf("grid_dueling_mlp")
    net = _net(c)
    tr = work.traffic(c, reg.cell("grid_mlp.grouped"))
    assert tr["updates_per_iter"] == 32
    macs, first = 8768, 256
    ctx = SimpleNamespace(work=work, config=c, traffic=tr, net=net)
    flops, nbytes = reg.kernel("fu_group_kernel").work(ctx)
    assert flops == 2 * 32 * 512 * (macs * 2 + macs + macs - first)
    P = 2 * (2 * 64 + 64 + 64 * 64 + 64) + 64 * 4 + 4 + 64 + 1
    assert net.n_params() == P and net.fused_collect()
    assert nbytes == 16384 * (4 * 4 + 8 + 12 + 16) + 24 * P + 16384 * 8 + 8
    assert work.step_flops(net, c, tr) == 131072 * 2 * macs + 16384 * (
        5 * 2 * macs - 2 * first)


def test_tree_levels_and_k2_bytes():
    from types import SimpleNamespace

    from port_bench.harness import work
    from port_bench.harness.registry import Registry

    assert work.tree_levels(1 << 20) == [1 << 20, 1 << 14, 1 << 8, 4, 1]
    assert work.tree_levels(1 << 18) == [1 << 18, 1 << 12, 64, 1]
    reg = Registry()
    c = _conf("grid_dueling_mlp")
    tr = work.traffic(c, reg.cell("grid_mlp.grouped"))
    flops, nbytes = reg.kernel("tree_sample_kernel").work(
        SimpleNamespace(work=work, config=c, traffic=tr, net=_net(c)))
    D = 16384
    assert nbytes == 16 * D + 4 * 64 * (16384 + 256 + 4) + 4 * 4 * 1
    assert flops == D * (64 + 64 + 64 + 4)


def test_drqn_k5_k6_and_step_work():
    """``grid_drqn.learner`` (U = 4, B = 512, T = 8, 16384 envs, LSTM(2,
    32) and dueling heads 32-1 and 32-4, double-Q): per step the cell's
    (2 + 32)·128 = 4352 and the heads' 32 + 128 multiply-adds, 4512. K5:
    2·U·B·T·4512·(2 + 2) FLOPs (``chip_smoke.py::_drqn_update_flops``);
    bytes: per window step obs and next obs 16, action 4, reward, done
    and mask 12, Q(s') 16, and the 4645 parameters with both moments read
    and written. K6: K4's count with the state rows h;c (64 f32) read and
    written per env. The step: the collect's forward over the envs, and
    per window step the forward on s, on s' twice, the weight gradient
    and every input gradient but x·wi's (2·128 multiply-adds)."""
    from types import SimpleNamespace

    from port_bench.harness import work
    from port_bench.harness.registry import Registry

    reg = Registry()
    c = _conf("grid_drqn")
    net = _net(c)
    tr = work.traffic(c, reg.cell("grid_drqn.learner"))
    assert (tr["updates_per_iter"], tr["trace_length"]) == (4, 8)
    assert tr["populate_steps"] == 101
    macs, P = 4512, (2 + 32 + 1) * 128 + 33 + 132
    assert sum(sum(m) for m in net.macs()) == macs and net.n_params() == P
    assert net.recurrent and net.fused_collect()
    ctx = SimpleNamespace(work=work, config=c, traffic=tr, net=net,
                          registry=reg)
    steps = 4 * 512 * 8
    flops, nbytes = reg.kernel("dr_group_kernel").work(ctx)
    assert flops == 2 * steps * macs * 4 == 591_396_864
    assert nbytes == steps * 48 + 24 * P + 16
    E = 16384
    k6_flops, k6_bytes = reg.kernel("fc_rnn_kernel").work(ctx)
    assert k6_flops == E * 2 * macs
    assert k6_bytes == (E * (8 + 12 + 4 + 4 + 24) + 4 * P + 4
                        + E * (32 + 8 + 12 + 4 + 4) + 12 + E * 2 * 4 * 64)
    assert work.step_flops(net, c, tr) == E * 2 * macs + steps * (
        5 * 2 * macs - 2 * 2 * 128)
