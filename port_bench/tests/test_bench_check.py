"""The check decides ``correct`` by the plain reference: the port agrees
with it at tiny sizes on the CPU, and a run with its timed path broken
underneath, or the reference's control in the port's place, reads not
correct."""
import json
import time

import pytest
import torch


def _run(reg, cell, wrap=None, seed=3):
    from port_bench.harness.bench import run_cell

    return run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter(), reg,
                    wrap=wrap, log=lambda s: None)


FEED_FORWARD = ("loss_gap", "grad_gap", "change_gap", "prio_gap", "td1_gap",
                "rows_bad")
RECURRENT = ("loss_gap", "grad_gap", "change_gap", "rows_bad", "hidden_gap")
CELLS = ["tiny_grid.grouped", "tiny_grid.u1", "tiny_conv.learner",
         "tiny_drqn.learner"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(bench_copy, cell):
    out = _run(bench_copy, cell, seed=2 ** 31 + 12345)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = RECURRENT if cell.startswith("tiny_drqn") else FEED_FORWARD
    assert tuple(out["checks"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS[:3])
def test_feed_forward_numbers_are_as_before(bench_copy, cell):
    """The feed-forward cells' check numbers, bit for bit, as the harness
    gave them before cells named their own numbers and a recurrent route
    was added (``fixtures/ff_checks.json``, one thread; they hold while
    the port's CPU twins keep their arithmetic)."""
    from conftest import FIXTURES

    want = json.loads((FIXTURES / "ff_checks.json").read_text())[cell]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed, nums in want.items():
            out = _run(bench_copy, cell, seed=int(seed))
            assert {k: repr(v["value"]) for k, v in out["checks"].items()
                    } == nums, (cell, seed)
    finally:
        torch.set_num_threads(threads)


def _half_batch(monkeypatch):
    """Half of each batch left out and the mean taken over the rest, in
    the port's loss heads (K1's, K3's and K5's CPU twins)."""
    from deepqlearning_tpu_torch.ops.cuda import (
        fused_drqn, fused_update, td_kernel)

    k1 = td_kernel.td_loss_plain

    def td_half(q_s, q_sp_online, q_sp_target, action, reward, done,
                weights, *args):
        B = q_s.shape[0]
        w = weights.clone()
        w[B // 2:] = 0.0
        loss, td, prio, grad = k1(q_s, q_sp_online, q_sp_target, action,
                                  reward, done, w, *args)
        return 2.0 * loss, td, prio, 2.0 * grad

    k3 = fused_update._fwd_bwd

    def fwd_bwd_half(plan, params, obs_s, obs_sp, action, reward, done,
                     weights, *args, **kw):
        B = obs_s.shape[0]
        w = weights.clone()
        w[B // 2:] = 0.0
        grads, td, prio, loss = k3(plan, params, obs_s, obs_sp, action,
                                   reward, done, w, *args, **kw)
        return {k: 2.0 * g for k, g in grads.items()}, td, prio, 2.0 * loss

    k8 = fused_drqn.fused_drqn_grads_plain

    def drqn_half(plan, params, obs, nobs, action, reward, done, mask, *args,
                  **kw):
        B = obs.shape[0]
        m = mask.clone()
        m[B // 2:] = 0.0
        flat, loss, gmax = k8(plan, params, obs, nobs, action, reward, done,
                              m, *args, **kw)
        return 2.0 * flat, 2.0 * loss, 2.0 * gmax

    monkeypatch.setattr(td_kernel, "td_loss_plain", td_half)
    monkeypatch.setattr(fused_update, "_fwd_bwd", fwd_bwd_half)
    monkeypatch.setattr(fused_drqn, "fused_drqn_grads_plain", drqn_half)


def _altered(monkeypatch):
    """One env's reward altered where the collect produces it."""
    from deepqlearning_tpu_torch.envs import gridworld, test_mdp

    for mod, cls, meth in ((gridworld, "SimpleGridWorld", "step_cols"),
                           (test_mdp, "TestMDP", "step_batch")):
        orig = getattr(getattr(mod, cls), meth)

        def step(self, *a, _orig=orig):
            state, obs, r, done = _orig(self, *a)
            r = r.clone()
            r[0] += 1.0
            return state, obs, r, done

        monkeypatch.setattr(getattr(mod, cls), meth, step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(bench_copy, monkeypatch,
                                               cell, fault):
    wrap = None
    if fault == "unchanged":
        wrap = lambda it: (lambda carry: carry)  # noqa: E731
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _altered(monkeypatch)
    out = _run(bench_copy, cell, wrap=wrap)
    assert not out["correct"], out["checks"]


def _no_reset(monkeypatch):
    """The recurrent state carried on where an episode ended (K6's CPU
    twin)."""
    from deepqlearning_tpu_torch.ops.cuda import fused_collect

    rest = fused_collect._collect_rest

    def keep_state(env, plan, q, nstate, **kw):
        out = rest(env, plan, q, nstate, **kw)
        return out if nstate is None else out[:-1] + (nstate,)

    monkeypatch.setattr(fused_collect, "_collect_rest", keep_state)


def _k5_twin(monkeypatch, change):
    """K5's CPU twin called with ``change(kw) -> kw`` applied to its
    windows and sizes."""
    from deepqlearning_tpu_torch.ops.cuda import fused_drqn

    k5 = fused_drqn.fused_drqn_group_update_plain
    names = ("obs", "nobs", "action", "reward", "done", "mask", "q_sp_tgt")

    def broken(plan, params, m, v, count, *windows, **kw):
        kw = change(dict(zip(names, windows), **kw))
        return k5(plan, params, m, v, count, *(kw.pop(n) for n in names),
                  **kw)

    monkeypatch.setattr(fused_drqn, "fused_drqn_group_update_plain", broken)


def _skip_update(kw):
    """The last sub-update left out."""
    n = kw["batch_size"] * (kw["n_updates"] - 1)
    for k in ("obs", "nobs", "action", "reward", "done", "mask",
              "q_sp_tgt"):
        kw[k] = kw[k][:n]
    return dict(kw, n_updates=kw["n_updates"] - 1)


def _no_mask(kw):
    """The windows' mask left out of the loss."""
    return dict(kw, mask=torch.ones_like(kw["mask"]))


@pytest.mark.parametrize("fault", ["no_reset", "skip_update", "no_mask"])
def test_a_broken_recurrent_path_reads_not_correct(bench_copy, monkeypatch,
                                                   fault):
    """Faults of the recurrent route, planted in the port's CPU twins: the
    state not reset at an episode's end (K6), one sub-update skipped and
    the mask dropped from the loss (K5)."""
    if fault == "no_reset":
        _no_reset(monkeypatch)
    else:
        _k5_twin(monkeypatch, _skip_update if fault == "skip_update"
                 else _no_mask)
    out = _run(bench_copy, "tiny_drqn.learner")
    assert not out["correct"], out["checks"]


def _control(reg, cell):
    from port_bench.harness import check
    from port_bench.readings import readings

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    nums = readings(cell, 4, ["program", "control"], dev, reg)
    limits = reg.cell(cell)["limits"]
    return (check.verdict(nums["program"], limits),
            check.verdict(nums["control"], limits))


def test_fp8_control_reads_not_correct(bench_copy):
    """The bf16 configuration's control: the reference with scaled e4m3
    products in the port's place."""
    program_ok, control_ok = _control(bench_copy, "tiny_conv.learner")
    assert program_ok and not control_ok


@pytest.mark.card
def test_tf32_control_reads_not_correct_on_the_card(bench_copy):
    """The f32 configuration's control: the reference with TF32 products
    in the port's place (TF32 exists on the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA device")
    for cell in ("tiny_grid.grouped", "tiny_grid.u1", "tiny_drqn.learner"):
        program_ok, control_ok = _control(bench_copy, cell)
        assert program_ok and not control_ok, cell
