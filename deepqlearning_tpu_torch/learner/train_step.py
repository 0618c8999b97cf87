"""Feed-forward DQN train steps (``deepqlearning_tpu.learner.train_step``).

sample → Bellman targets (double-Q or max, outside the gradient) →
importance-weighted Huber loss → gradient → Adam → priority update.

State is updated IN PLACE: parameters, Adam moments and the Adam count by
the optimizer (or kernel K3), replay tree levels by the priority update.
The Adam state has one layout for every path, ``AdamState(m, v, count)``
with ``m``/``v`` shaped like the parameter dict and ``count`` an int32
scalar tensor.

Paths:
* ``make_dqn_train_step``: one update per call; its loss head is kernel K1
  (``ops/cuda/td_kernel.py``) unless ``use_kernel=False``.
* ``make_grouped_dqn_train_step``: U updates sharing one sample and one
  merged priority update, composed of plain torch ops (the CPU reference and
  the ``fused_updates=False`` path).
* ``make_fused_grouped_train_step``: the same U updates through kernel K3
  (``ops/cuda/fused_update.py``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops.helpers import globalnorm, huber_loss


class TrainResult(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: "AdamState"
    replay_state: object
    loss: torch.Tensor
    grad_norm: torch.Tensor


class AdamState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: torch.Tensor  # int32 scalar


class Adam:
    """Adam with optax's bias correction (β 0.9/0.999, ε 1e-8), as plain
    tensor ops; ``update`` works in place on params, m, v and count."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            m={k: torch.zeros_like(p) for k, p in params.items()},
            v={k: torch.zeros_like(p) for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> AdamState:
        state.count.add_(1)
        t = state.count.float()
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        for k, g in grads.items():
            m, v = state.m[k], state.v[k]
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            params[k].sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2)
                                                   + self.eps)))
        return state


def make_optimizer(learning_rate: float) -> Adam:
    return Adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8)


def _bellman_targets(network, params, target_params, next_obs, reward, done,
                     gamma, double_q):
    """r + (1-done) * gamma * Q_target(s', a*) with a* from the online net
    (double-Q) or the plain max."""
    with torch.no_grad():
        q_tgt, _ = network.apply(target_params, next_obs)
        if double_q:
            q_onl, _ = network.apply(params, next_obs)
            best = torch.argmax(q_onl, dim=-1)
            q_sp_max = torch.gather(q_tgt, -1, best[..., None])[..., 0]
        else:
            q_sp_max = q_tgt.max(dim=-1).values
        return reward + (1.0 - done) * gamma * q_sp_max


def _make_batch_update(network, buffer, gamma, double_q, optimizer,
                       use_kernel: bool):
    """One (batch, weights) → grads → Adam. Returns ``update(params,
    target_params, opt_state, batch, weights, q_sp_tgt=None) -> (params,
    opt_state, td, prio_or_None, loss, grad_norm)``."""

    def update(params, target_params, opt_state, batch, weights,
               q_sp_tgt=None):
        B = batch.action.shape[0]
        with torch.no_grad():
            if q_sp_tgt is None:
                q_sp_tgt, _ = network.apply(target_params, batch.next_obs)
            q_sp_onl = (network.apply(params, batch.next_obs)[0]
                        if double_q else q_sp_tgt)
        p = {k: t.detach().requires_grad_() for k, t in params.items()}
        q, _ = network.apply(p, batch.obs)
        if use_kernel:
            from ..ops.cuda.td_kernel import td_loss

            loss, td, prio = td_loss(
                q, q_sp_onl, q_sp_tgt, batch.action, batch.reward,
                batch.done, weights, gamma, buffer.alpha, buffer.eps,
                double_q)
        else:
            if double_q:
                best = torch.argmax(q_sp_onl, dim=-1)
                q_sp_max = torch.gather(q_sp_tgt, 1, best[:, None])[:, 0]
            else:
                q_sp_max = q_sp_tgt.max(dim=-1).values
            q_targets = batch.reward + (1.0 - batch.done) * gamma * q_sp_max
            q_sa = torch.gather(q, 1, batch.action.long()[:, None])[:, 0]
            td = q_sa - q_targets
            loss = huber_loss(weights * td).sum() / B
            prio = None
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        grad_norm = globalnorm(grads)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, td.detach(), prio, loss.detach(), grad_norm

    return update


def _no_axis(axis_name):
    if axis_name is not None:
        raise NotImplementedError(
            "data-parallel training (axis_name) is not ported yet")


def make_dqn_train_step(network, buffer, gamma: float, double_q: bool,
                        learning_rate: float, axis_name: Optional[str] = None,
                        use_kernel: Optional[bool] = None):
    """One update per call. Returns ``(step, optimizer)`` with
    ``step(params, target_params, opt_state, replay_state, u=None,
    generator=None) -> TrainResult``; ``u`` are the sample's uniforms [B].
    ``use_kernel`` (default on) takes kernel K1 for the loss head."""
    _no_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                use_kernel is not False)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch, idx, weights = buffer.sample(replay_state, u=u,
                                            generator=generator)
        params, opt_state, td, prio, loss, grad_norm = update(
            params, target_params, opt_state, batch, weights)
        replay_state = buffer.update_priorities(replay_state, idx, td,
                                                priorities=prio)
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_grouped_dqn_train_step(network, buffer, gamma: float,
                                double_q: bool, learning_rate: float,
                                n_updates: int,
                                axis_name: Optional[str] = None):
    """``n_updates`` sequential Adam updates sharing ONE stratified sample
    (u-major: sub-batch u is rows ``[u·B, (u+1)·B)``) and one merged
    priority update; the target net runs once on all U·B rows. Plain torch
    ops throughout."""
    _no_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                use_kernel=False)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch, idx, weights = buffer.sample_n(replay_state, U, u=u,
                                              generator=generator)
        with torch.no_grad():
            q_sp_tgt_all, _ = network.apply(target_params, batch.next_obs)
        tds = []
        loss = grad_norm = None
        for k in range(U):
            sl = slice(k * B, (k + 1) * B)
            sub = type(batch)(*(x[sl] for x in batch))
            params, opt_state, td, _, loss, grad_norm = update(
                params, target_params, opt_state, sub, weights[sl],
                q_sp_tgt=q_sp_tgt_all[sl])
            tds.append(td)
        replay_state = buffer.update_priorities(replay_state, idx,
                                                torch.cat(tds))
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_fused_grouped_train_step(network, buffer, gamma: float,
                                  double_q: bool, learning_rate: float,
                                  n_updates: int):
    """The grouped step with forward/TD/backward/Adam of all U sub-updates
    in kernel K3. The target-net forward on all U·B rows stays outside the
    kernel, as plain torch."""
    from ..ops.cuda.fused_update import fused_group_update, plan_for

    plan = plan_for(network)
    if plan is None:
        raise ValueError("network not supported by the fused update kernel")
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch, idx, weights = buffer.sample_n(replay_state, U, u=u,
                                              generator=generator)
        with torch.no_grad():
            q_sp_tgt_all, _ = network.apply(target_params, batch.next_obs)
            tds, prios, loss, gnorm = fused_group_update(
                plan, params, opt_state.m, opt_state.v, opt_state.count,
                batch.obs, batch.next_obs, batch.action, batch.reward,
                batch.done, weights, q_sp_tgt_all, gamma=gamma,
                double_q=double_q, lr=learning_rate, alpha=buffer.alpha,
                eps=buffer.eps, batch_size=B, n_updates=U)
        replay_state = buffer.update_priorities(
            replay_state, idx, tds.reshape(-1), priorities=prios.reshape(-1))
        return TrainResult(params, opt_state, replay_state, loss, gnorm)

    return step, optimizer


@torch.no_grad()
def sync_target(params, target_params, do_sync: bool):
    """Hard target copy, in place, when ``do_sync``."""
    if do_sync:
        for k, t in target_params.items():
            t.copy_(params[k])
    return target_params
