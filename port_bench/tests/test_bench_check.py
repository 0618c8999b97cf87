"""The check decides ``correct`` by the plain reference: the port agrees
with it at tiny sizes on the CPU, and a run with its timed path broken
underneath, or the reference's control in the port's place, reads not
correct."""
import time

import pytest
import torch


def _run(reg, cell, wrap=None, seed=3):
    from port_bench.harness.bench import run_cell

    return run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter(), reg,
                    wrap=wrap, log=lambda s: None)


@pytest.mark.parametrize("cell", ["tiny_grid.grouped", "tiny_grid.u1",
                                  "tiny_conv.learner"])
def test_port_agrees_with_the_reference(bench_copy, cell):
    out = _run(bench_copy, cell, seed=2 ** 31 + 12345)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "prio_gap", "td1_gap", "rows_bad"}
    assert list(out)[-1] == "checks"


def _half_batch(monkeypatch):
    """Half of each batch left out and the mean taken over the rest, in
    the port's loss heads (K1's and K3's CPU twins)."""
    from deepqlearning_tpu_torch.ops.cuda import fused_update, td_kernel

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

    monkeypatch.setattr(td_kernel, "td_loss_plain", td_half)
    monkeypatch.setattr(fused_update, "_fwd_bwd", fwd_bwd_half)


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
@pytest.mark.parametrize("cell", ["tiny_grid.grouped", "tiny_grid.u1",
                                  "tiny_conv.learner"])
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
    for cell in ("tiny_grid.grouped", "tiny_grid.u1"):
        program_ok, control_ok = _control(bench_copy, cell)
        assert program_ok and not control_ok, cell
