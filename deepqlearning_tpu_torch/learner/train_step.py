"""DQN and DRQN train steps (``deepqlearning_tpu.learner.train_step``).

sample → Bellman targets (double-Q or max, outside the gradient) →
importance-weighted Huber loss → gradient → Adam → priority update. The
recurrent (DRQN) steps draw trace windows from the episode replay, take
their targets from zero-state unrolls of the online and target nets over
s', and minimise the masked, time-summed Huber loss / (B·T); no priorities.

State is updated IN PLACE: parameters, Adam moments and the Adam count by
the optimizer (or kernel K3), replay tree levels by the priority update.
The Adam state has one layout for every path, ``AdamState(m, v, count)``
with ``m``/``v`` shaped like the parameter dict and ``count`` an int32
scalar tensor.

Paths:
* ``make_dqn_train_step``: one update per call; its loss head is kernel K1
  (``ops/cuda/td_kernel.py``) unless ``use_kernel=False``.
* ``make_grouped_dqn_train_step``: U updates sharing one sample and one
  merged priority update, plain torch ops around a loss head that is kernel
  K1 per sub-update unless ``use_kernel=False`` (the route of networks the
  K3 plan refuses, and of ``fused_updates=False`` without K1).
* ``make_fused_grouped_train_step``: the same U updates through kernel K3
  (``ops/cuda/fused_update.py``).
* ``make_drqn_train_step`` / ``make_grouped_drqn_train_step``: one / U
  recurrent updates per call, plain torch with autograd.
* ``make_fused_grouped_drqn_train_step``: U recurrent updates through
  kernel K5 (``ops/cuda/fused_drqn.py``), U >= 1.

Data parallelism: every step but the two whole-phase kernel steps (K3, K5,
whose in-kernel Adam cannot average across ranks) takes an ``axis_name``,
one ``torch.distributed`` process group or a tuple of them (innermost
first), and averages each sub-update's gradient over it with
:func:`pmean_flat` before Adam. The logged loss stays the rank's own; the
logged gradient norm is that of the averaged gradient.
* ``make_fused_dp_train_step``: the grouped step with each sub-update's
  forward/TD/backward in kernel K7 (``fused_grads``), then the all-reduce
  of its flat gradient and one Adam launch.
* ``make_fused_dp_drqn_train_step``: the same for recurrent updates, with
  kernel K8 (``fused_drqn_grads``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops.helpers import flatten, huber_loss, select_action, unflatten
from ..utils import profiling


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
    tensor ops; ``update`` works in place on params, m, v and count.

    The moments take each parameter's dtype. On a non-f32 (bf16) leaf every
    step runs in that dtype, as ``optax.adam`` does on bf16 leaves: the
    constants β, 1 - β, ε and -lr rounded to the dtype first (JAX's weak
    typing), the moment updates, the bias corrections ``1 - β^t`` computed
    in f32 and cast to the moment's dtype
    (``optax.tree_utils.tree_bias_correction``), ``m̂ / (√v̂ + ε)`` and
    ``p + (-lr)·u``, each operation rounded to the dtype."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self._consts = {}
        # per device: kernel K9's max-abs ticket and partials
        # (ops/cuda/adam.py)
        self.workspace = {}

    def _rounded(self, dtype):
        """(1-β1, β1, 1-β2, β2, ε, -lr) rounded to ``dtype``, as floats: a
        bf16 tensor times such a float is the product of two bf16 values,
        exact in f32 and then rounded, as jnp multiplies them. For f32 this
        is the rounding PyTorch applies to a Python scalar anyway."""
        if dtype not in self._consts:
            self._consts[dtype] = tuple(
                torch.tensor(x, dtype=dtype).item() for x in (
                    1.0 - self.b1, self.b1, 1.0 - self.b2, self.b2, self.eps,
                    -self.lr))
        return self._consts[dtype]

    def init(self, params) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            m={k: torch.zeros_like(p) for k, p in params.items()},
            v={k: torch.zeros_like(p) for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def update(self, grads, state: AdamState, params):
        """One Adam step from ``grads``, in place on ``params``, ``state.m``,
        ``state.v`` and ``state.count``. Returns ``(state, grad_norm)``, the
        gradients' max-abs entry (``ops/helpers.py::globalnorm``) taken in
        the same pass: kernel K9 on the card, its plain twin (ATen ops) on
        the CPU, bit for bit alike (``ops/cuda/adam.py``)."""
        from ..ops.cuda.adam import adam_update

        return state, adam_update(self, grads, state, params)


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


def _groups(axis_name) -> tuple:
    return (tuple(axis_name) if isinstance(axis_name, (tuple, list))
            else (axis_name,))


def check_axis(axis_name) -> None:
    """``axis_name`` must be None, a ``torch.distributed`` process group or
    a non-empty tuple of them (innermost first)."""
    if axis_name is None:
        return
    import torch.distributed as dist

    groups = _groups(axis_name)
    if not groups or not all(isinstance(g, dist.ProcessGroup)
                             for g in groups):
        raise TypeError(
            "axis_name must be a torch.distributed ProcessGroup or a tuple "
            f"of them (e.g. DeviceMesh.get_group), got {axis_name!r}")


def pmean_flat(grads, axis_name):
    """Average gradients over ``axis_name`` as ONE flat f32 vector.

    ``grads`` is a dict of tensors (concatenated, reduced and split back
    into new tensors) or a flat f32 vector, which is reduced in place and
    returned (the fused steps' kernels write that vector directly).
    ``axis_name`` is one process group (``all_reduce(SUM)``, then divide by
    its size: a ``pmean``) or a tuple of groups, innermost (ICI) first:
    ``all_reduce(SUM)`` over each in order, then divide by the product of
    their sizes (the hierarchical mode of the JAX ``pmean_flat``). The
    collective is issued even over a group of one; the reduction runs in
    f32 and each gradient comes back in its own dtype. The recorder's
    ``train.pmean_flat`` counts the calls."""
    import torch.distributed as dist

    profiling.count("train.pmean_flat")
    flat = grads if isinstance(grads, torch.Tensor) else flatten(grads, grads)
    n = 1
    for g in _groups(axis_name):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
        n *= dist.get_world_size(g)
    flat.div_(n)
    return flat if isinstance(grads, torch.Tensor) else unflatten(
        flat, grads, grads)


def _make_batch_update(network, buffer, gamma, double_q, optimizer,
                       use_kernel: bool, axis_name=None):
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
        # a bf16 network's Q values in f32 (exact), as the JAX step feeds
        # its TD head; autograd carries the cotangent back to bf16
        q, q_sp_onl, q_sp_tgt = q.float(), q_sp_onl.float(), q_sp_tgt.float()
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
            q_sa = select_action(q, batch.action)
            td = q_sa - q_targets
            loss = huber_loss(weights * td).sum() / B
            prio = None
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if axis_name is not None:
            grads = pmean_flat(grads, axis_name)
        _, grad_norm = optimizer.update(grads, opt_state, params)
        return params, opt_state, td.detach(), prio, loss.detach(), grad_norm

    return update


def make_dqn_train_step(network, buffer, gamma: float, double_q: bool,
                        learning_rate: float, axis_name=None,
                        use_kernel: Optional[bool] = None):
    """One update per call. Returns ``(step, optimizer)`` with
    ``step(params, target_params, opt_state, replay_state, u=None,
    generator=None) -> TrainResult``; ``u`` are the sample's uniforms [B].
    ``use_kernel`` (default on) takes kernel K1 for the loss head."""
    check_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                use_kernel is not False, axis_name)

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
                                axis_name=None,
                                use_kernel: Optional[bool] = None):
    """``n_updates`` sequential Adam updates sharing ONE stratified sample
    (u-major: sub-batch u is rows ``[u·B, (u+1)·B)``) and one merged
    priority update; the target net runs once on all U·B rows.
    ``use_kernel`` (default on) takes kernel K1 for each sub-update's loss
    head, whose priorities, in u-major order, go to the merged update."""
    check_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    use_kernel = use_kernel is not False
    update = _make_batch_update(network, buffer, gamma, double_q, optimizer,
                                use_kernel, axis_name)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch, idx, weights = buffer.sample_n(replay_state, U, u=u,
                                              generator=generator)
        with torch.no_grad():
            q_sp_tgt_all, _ = network.apply(target_params, batch.next_obs)
        tds, prios = [], []
        loss = grad_norm = None
        for k in range(U):
            sl = slice(k * B, (k + 1) * B)
            sub = type(batch)(*(x[sl] for x in batch))
            params, opt_state, td, prio, loss, grad_norm = update(
                params, target_params, opt_state, sub, weights[sl],
                q_sp_tgt=q_sp_tgt_all[sl])
            tds.append(td)
            prios.append(prio)
        replay_state = buffer.update_priorities(
            replay_state, idx, torch.cat(tds),
            priorities=torch.cat(prios) if use_kernel else None)
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


def make_fused_dp_train_step(network, buffer, gamma: float, double_q: bool,
                             learning_rate: float, n_updates: int,
                             axis_name):
    """The data-parallel grouped step: one u-major sample of U·B rows and
    the target net once on all of them, then per sub-update kernel K7
    (forward/TD/backward, emitting the flat gradient), :func:`pmean_flat`
    of that vector over ``axis_name`` and one Adam launch at ``t = count +
    u + 1`` (``ops/cuda/fused_update.py::fused_dp_group_update``); last,
    one merged priority update from the U sub-updates' td/prio."""
    from ..ops.cuda.fused_update import fused_dp_group_update, plan_for

    check_axis(axis_name)
    if axis_name is None:
        raise ValueError("the data-parallel step needs an axis_name")
    plan = plan_for(network)
    if plan is None:
        raise ValueError("network not supported by the fused update kernel")
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    reduce = lambda flat: pmean_flat(flat, axis_name)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch, idx, weights = buffer.sample_n(replay_state, U, u=u,
                                              generator=generator)
        with torch.no_grad():
            q_sp_tgt_all, _ = network.apply(target_params, batch.next_obs)
            tds, prios, loss, gnorm = fused_dp_group_update(
                plan, params, opt_state.m, opt_state.v, opt_state.count,
                batch.obs, batch.next_obs, batch.action, batch.reward,
                batch.done, weights, q_sp_tgt_all, reduce=reduce,
                gamma=gamma, double_q=double_q, lr=learning_rate,
                alpha=buffer.alpha, eps=buffer.eps, batch_size=B,
                n_updates=U)
        replay_state = buffer.update_priorities(
            replay_state, idx, tds.reshape(-1), priorities=prios.reshape(-1))
        return TrainResult(params, opt_state, replay_state, loss, gnorm)

    return step, optimizer


def _time_major(x):
    return x.transpose(0, 1)


def _drqn_targets(network, params, target_params, nobs_t, r_t, d_t, gamma,
                  double_q):
    """``r + (1-done)·γ·Q_target(s', a*)`` over time-major ``[T, B]`` from
    zero-state unrolls over s' of the target and (double-Q) online nets."""
    with torch.no_grad():
        init = network.init_state(nobs_t.shape[1], nobs_t.device)
        q_tgt, _ = network.apply_sequence(target_params, nobs_t, init)
        if double_q:
            q_onl, _ = network.apply_sequence(params, nobs_t, init)
            best = torch.argmax(q_onl, dim=-1)
            q_sp_max = torch.gather(q_tgt, -1, best[..., None])[..., 0]
        else:
            q_sp_max = q_tgt.max(dim=-1).values
        return r_t + (1.0 - d_t) * gamma * q_sp_max


def _make_drqn_update(network, gamma, double_q, optimizer, axis_name=None):
    """One EpisodeBatch → grads (autograd) → Adam, in place. Returns
    ``update(params, target_params, opt_state, batch) -> (loss, grad_norm)``."""

    def update(params, target_params, opt_state, batch):
        B, T = batch.action.shape
        obs_t, nobs_t = _time_major(batch.obs), _time_major(batch.next_obs)
        a_t, r_t, d_t, m_t = (_time_major(x) for x in (
            batch.action, batch.reward, batch.done, batch.mask))
        q_targets = _drqn_targets(network, params, target_params, nobs_t,
                                  r_t, d_t, gamma, double_q)
        p = {k: t.detach().requires_grad_() for k, t in params.items()}
        q_seq, _ = network.apply_sequence(
            p, obs_t, network.init_state(B, obs_t.device))     # [T, B, A]
        q_sa = select_action(q_seq, a_t)
        loss = huber_loss(m_t * (q_sa - q_targets)).sum() / B / T
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if axis_name is not None:
            grads = pmean_flat(grads, axis_name)
        _, grad_norm = optimizer.update(grads, opt_state, params)
        return loss.detach(), grad_norm

    return update


def make_drqn_train_step(network, buffer, gamma: float, double_q: bool,
                         learning_rate: float,
                         axis_name=None):
    """One recurrent update per call: ``step(params, target_params,
    opt_state, replay_state, u=None, generator=None) -> TrainResult``, with
    ``u`` the sample's injected ``EpisodeDraws``."""
    check_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    update = _make_drqn_update(network, gamma, double_q, optimizer, axis_name)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch = buffer.sample(replay_state, draws=u, generator=generator)
        loss, grad_norm = update(params, target_params, opt_state, batch)
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_grouped_drqn_train_step(network, buffer, gamma: float,
                                 double_q: bool, learning_rate: float,
                                 n_updates: int,
                                 axis_name=None):
    """``n_updates`` sequential recurrent updates on one u-major draw of
    ``n_updates · B`` windows (sub-batch u is rows ``[u·B, (u+1)·B)``):
    exactly U ungrouped calls on pre-drawn batches (uniform sampling, no
    priorities)."""
    check_axis(axis_name)
    optimizer = make_optimizer(learning_rate)
    B, U = buffer.batch_size, int(n_updates)
    update = _make_drqn_update(network, gamma, double_q, optimizer, axis_name)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch = buffer.sample_n(replay_state, U, draws=u,
                                generator=generator)
        loss = grad_norm = None
        for k in range(U):
            sub = type(batch)(*(x[k * B:(k + 1) * B] for x in batch))
            loss, grad_norm = update(params, target_params, opt_state, sub)
        return TrainResult(params, opt_state, replay_state, loss, grad_norm)

    return step, optimizer


def make_fused_grouped_drqn_train_step(network, buffer, gamma: float,
                                       double_q: bool, learning_rate: float,
                                       n_updates: int):
    """The grouped recurrent step with the online unrolls, the masked loss,
    BPTT and Adam of all U sub-updates in kernel K5. The target net's Q(s')
    (one zero-state unroll over all U·B windows; the target net is frozen
    within the step) comes before it from kernel K11
    (``ops/cuda/fused_drqn.py::drqn_target_q``)."""
    from ..ops.cuda.fused_drqn import (
        drqn_plan_for, drqn_target_q, fused_drqn_group_update)

    B, T, U = buffer.batch_size, buffer.trace_length, int(n_updates)
    plan = drqn_plan_for(network, T, B, double_q)
    if plan is None:
        raise ValueError("network not supported by the fused DRQN kernel")
    optimizer = make_optimizer(learning_rate)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch = buffer.sample_n(replay_state, U, draws=u,
                                generator=generator)
        with torch.no_grad():
            q_tgt = drqn_target_q(plan, network, target_params,
                                  batch.next_obs)            # [U·B, T, A]
            loss, gnorm = fused_drqn_group_update(
                plan, params, opt_state.m, opt_state.v, opt_state.count,
                batch.obs, batch.next_obs, batch.action, batch.reward,
                batch.done, batch.mask, q_tgt, gamma=gamma,
                double_q=double_q, lr=learning_rate, batch_size=B,
                n_updates=U)
        return TrainResult(params, opt_state, replay_state, loss, gnorm)

    return step, optimizer


def make_fused_dp_drqn_train_step(network, buffer, gamma: float,
                                  double_q: bool, learning_rate: float,
                                  n_updates: int, axis_name):
    """The data-parallel recurrent step: one u-major draw of U·B windows and
    the target net's zero-state unroll once on all of them (kernel K11,
    ``ops/cuda/fused_drqn.py::drqn_target_q``), then per sub-update kernel
    K8 (unrolls, masked loss, BPTT, emitting the flat gradient),
    :func:`pmean_flat` of that vector over ``axis_name`` and one Adam
    launch at ``t = count + u + 1``
    (``ops/cuda/fused_drqn.py::fused_drqn_dp_group_update``). U >= 1."""
    from ..ops.cuda.fused_drqn import (
        drqn_plan_for, drqn_target_q, fused_drqn_dp_group_update)

    check_axis(axis_name)
    if axis_name is None:
        raise ValueError("the data-parallel step needs an axis_name")
    B, T, U = buffer.batch_size, buffer.trace_length, int(n_updates)
    plan = drqn_plan_for(network, T, B, double_q)
    if plan is None:
        raise ValueError("network not supported by the fused DRQN kernel")
    optimizer = make_optimizer(learning_rate)
    reduce = lambda flat: pmean_flat(flat, axis_name)

    def step(params, target_params, opt_state, replay_state, u=None,
             generator=None):
        batch = buffer.sample_n(replay_state, U, draws=u,
                                generator=generator)
        with torch.no_grad():
            q_tgt = drqn_target_q(plan, network, target_params,
                                  batch.next_obs)            # [U·B, T, A]
            loss, gnorm = fused_drqn_dp_group_update(
                plan, params, opt_state.m, opt_state.v, opt_state.count,
                batch.obs, batch.next_obs, batch.action, batch.reward,
                batch.done, batch.mask, q_tgt, reduce=reduce,
                gamma=gamma, double_q=double_q, lr=learning_rate,
                batch_size=B, n_updates=U)
        return TrainResult(params, opt_state, replay_state, loss, gnorm)

    return step, optimizer


@torch.no_grad()
def sync_target(params, target_params, do_sync):
    """Hard target copy, in place, where ``do_sync`` (a 0-d bool tensor on
    the parameters' device) holds: a select, as the JAX ``sync_target`` is
    a ``jnp.where``, so the decision stays on the device. The select runs
    once over all the parameters of a dtype laid end to end (a kernel per
    parameter would cost a graph replay more than the copy)."""
    by_dtype = {}
    for k, t in target_params.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    for keys in by_dtype.values():
        ts = [target_params[k] for k in keys]
        flat = torch.where(do_sync,
                           torch.cat([params[k].reshape(-1) for k in keys]),
                           torch.cat([t.reshape(-1) for t in ts]))
        parts = flat.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [x.view_as(t) for x, t in zip(parts, ts)])
    return target_params
