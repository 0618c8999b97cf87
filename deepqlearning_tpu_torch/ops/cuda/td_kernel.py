"""K1: fused TD loss / priority head (``csrc/td_kernel.cu``).

Replaces ``td_loss_fused`` of ``deepqlearning_tpu/ops/pallas/td_kernel.py``:
double-Q argmax of the online Q(s') (or the plain max of the target),
target ``r + (1-d)·γ·Q_tgt(s', a*)``, ``td = Q(s,a) - target``,
``loss = Σ huber(w·td) / B``, priorities ``(|td| + ε)^α`` and
``dL/dq_s = w·clip(w·td, ±1)/B`` at the taken action.

On the card the kernel is bound by its launch and one thread's chain of
loads and instructions (a row per thread, float4 rows at A = 4, one
barrier; past 512 rows a cluster of blocks; see the source).
The wrapper hands the kernel int32 or int64 actions as they are and the
row vectors at their strides (the replay's reward and done are columns of
its row matrix), so it launches nothing but K1.
:func:`td_loss` is a ``torch.autograd.Function``:
its forward runs the kernel for CUDA tensors and :func:`td_loss_plain` for
CPU tensors; its backward is ``grad · g_loss``, plain, as the TPU's custom
VJP was. The gradient flows into ``q_s`` only.
"""
from __future__ import annotations

import torch

from ..helpers import action_mask, select_action
from . import build


def td_loss_plain(q_s, q_sp_online, q_sp_target, action, reward, done,
                  weights, gamma: float, alpha: float, eps: float,
                  double_q: bool):
    """Plain PyTorch version: ``(loss, td [B], prio [B], grad [B, A])``.
    An action outside ``[0, A)`` selects nothing (``ops/helpers.py::
    action_mask``), as the kernel's range test does."""
    B = q_s.shape[0]
    if double_q:
        best = torch.argmax(q_sp_online, dim=1)
        q_sp_max = torch.gather(q_sp_target, 1, best[:, None])[:, 0]
    else:
        q_sp_max = q_sp_target.max(dim=1).values
    target = reward + (1.0 - done) * gamma * q_sp_max
    q_sa = select_action(q_s, action)
    td = q_sa - target
    x = weights * td
    absx = x.abs()
    quad = absx.clamp(max=1.0)
    loss = (0.5 * quad * quad + (absx - quad)).sum() * (1.0 / B)
    prio = (td.abs() + eps) ** alpha
    g = weights * x.clamp(-1.0, 1.0) * (1.0 / B)
    grad = torch.where(action_mask(q_s, action), g[:, None], 0.0)
    return loss, td, prio, grad


def td_loss_cuda(q_s, q_sp_online, q_sp_target, action, reward, done,
                 weights, gamma: float, alpha: float, eps: float,
                 double_q: bool):
    """Launch K1 on the current stream; same outputs as the plain version."""
    q_s, q_sp_online, q_sp_target = (
        t.float().contiguous() for t in (q_s, q_sp_online, q_sp_target))
    if action.dtype not in (torch.int32, torch.int64):
        action = action.long()
    reward, done, weights = (t.float() for t in (reward, done, weights))
    build.require_cuda(q_s, q_sp_online, q_sp_target)
    B, A = q_s.shape
    for name, t in (("q_sp_online", q_sp_online), ("q_sp_target", q_sp_target)):
        build.require_shape(t, (B, A), name)
    for name, t in (("action", action), ("reward", reward), ("done", done),
                    ("weights", weights)):
        build.require_shape(t, (B,), name)
        if t.device != q_s.device:
            raise ValueError(f"{name}: expected {q_s.device}, got {t.device}")
    loss = torch.empty((), dtype=torch.float32, device=q_s.device)
    td = torch.empty(B, dtype=torch.float32, device=q_s.device)
    prio = torch.empty_like(td)
    grad = torch.empty_like(q_s)
    lib = build.library()
    err = lib.dq_td_loss(
        q_s.data_ptr(), q_sp_online.data_ptr(), q_sp_target.data_ptr(),
        action.data_ptr(), action.element_size(), action.stride(0),
        reward.data_ptr(), reward.stride(0), done.data_ptr(), done.stride(0),
        weights.data_ptr(), weights.stride(0), B, A, gamma, alpha, eps,
        int(bool(double_q)), loss.data_ptr(), td.data_ptr(), prio.data_ptr(),
        grad.data_ptr(), build.stream_ptr(q_s.device))
    build.check(err, "td_loss")
    return loss, td, prio, grad


def empty_cuda(device, B: int) -> None:
    """Launch the empty kernel as K1 is launched for ``B`` rows (its
    blocks, one cluster, and threads) on ``device``'s current stream: the
    launch floor under K1, for timing only."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on CUDA, not {device}")
    err = build.library().dq_empty(B, build.stream_ptr(device))
    build.check(err, "empty")


class _TDLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_s, q_sp_online, q_sp_target, action, reward, done,
                weights, gamma, alpha, eps, double_q):
        fn = td_loss_cuda if q_s.is_cuda else td_loss_plain
        loss, td, prio, grad = fn(q_s.detach(), q_sp_online.detach(),
                                  q_sp_target.detach(), action, reward, done,
                                  weights, gamma, alpha, eps, double_q)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(td, prio)
        return loss, td, prio

    @staticmethod
    def backward(ctx, g_loss, g_td, g_prio):
        (grad,) = ctx.saved_tensors
        return (grad * g_loss,) + (None,) * 10


def td_loss(q_s, q_sp_online, q_sp_target, action, reward, done, weights,
            gamma: float, alpha: float, eps: float, double_q: bool):
    """``(loss, td [B], prio [B])``, differentiable in ``q_s``."""
    return _TDLoss.apply(q_s, q_sp_online, q_sp_target, action, reward, done,
                         weights, float(gamma), float(alpha), float(eps),
                         bool(double_q))
