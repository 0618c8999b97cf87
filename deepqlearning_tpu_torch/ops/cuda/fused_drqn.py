"""K5: the recurrent (DRQN) train phase, U sub-updates, and K8: one
sub-update emitting gradients, for data parallelism (``csrc/fused_drqn.cu``).

Replaces ``fused_drqn_group_update`` of ``deepqlearning_tpu/ops/pallas/
fused_drqn.py``. Each sub-update u takes the trace windows ``[u·B, (u+1)·B)``
of the u-major sample and runs, per window: the online unroll over s' from
a zero state for the double-Q argmax (first max), the target
``r + (1-d)·γ·Q_tgt(s', a*)`` against the precomputed target-net Q(s'), the
unroll over s with its activations kept, the masked Huber loss summed over
time and windows / (B·T), the hand-derived BPTT through the Dense or
dueling head, the LSTM or GRU cell and the Dense layers before it, then
Adam with bias correction at ``t = count + u + 1``. Params, m and v are
updated IN PLACE and ``count`` advances by U in place. Returns the last
sub-update's loss and max-abs gradient.

On the card: two launches per sub-update on the current stream, no host
sync. (a) ``dr_fwd_bwd_kernel``: one warp per trace window, its lanes split
every layer's output columns; the parameters, the window's activations and
the warp's own gradient accumulators live in shared memory, and each block
sums its warps' gradients in a fixed order into a per-block partial.
(b) ``dr_adam_kernel``: one block sums the block partials in a fixed order,
takes the max-abs gnorm and applies Adam. Every sum has a fixed order, so
runs are deterministic.

K8 (:func:`fused_drqn_grads`) replaces ``fused_drqn_grads`` of the same
JAX file: launch (a) on one sub-batch of B windows, then the fixed-order
multi-block reduce K7 uses, into one flat gradient in ``plan.names``
order with the loss and the local max-abs.
:func:`fused_drqn_dp_group_update` is the data-parallel step's U
sub-updates: per sub-update K8, a caller's reduce of the flat vector in
place, and K5's one-block Adam kernel on it.

:func:`drqn_plan_for` is the gate, on the network family of the JAX
kernel: ``[Flatten]* [Dense]* LSTM|GRU`` and a Dense or dueling head with a
scalar value head, with this card's limits in place of the TPU's VMEM
budget: every width at most ``MAX_WIDTH``, at most ``MAX_ACTIONS`` actions
and ``build.DR_MAXL`` Dense layers, and a block of one warp (the params, a
window's activations and one gradient copy) within ``MAX_SMEM`` bytes of
shared memory.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ...models.chain import GRU, LSTM, Chain, Flatten, gru_cell, lstm_cell
from ...models.dueling import DuelingNetwork
from ...ops.helpers import flatten, huber_loss, unflatten
from . import build
from .fused_update import (
    _ACTS, MAX_ACTIONS, MAX_SMEM, FusedPlan, LayerPlan, _apply_act,
    adam_flat_plain, adam_plain, dense_plans, q_values)

MAX_WIDTH = 256
MAX_WARPS = 8  # warps (trace windows) per block of dr_fwd_bwd_kernel


@dataclasses.dataclass(frozen=True)
class CellPlan:
    kind: str     # 'lstm' (gates i,f,g,o) | 'gru' (gates r,z,n)
    in_dim: int
    hidden: int
    prefix: str   # parameter keys prefix + 'wi' / 'wh' / 'b'
    layer_idx: int  # position of the cell in its chain's state tuple

    @property
    def n_gates(self) -> int:
        return 4 if self.kind == "lstm" else 3

    @property
    def names(self):
        return [self.prefix + k for k in ("wi", "wh", "b")]


def cell_plan(layer, prefix: str, idx: int) -> Optional[CellPlan]:
    if isinstance(layer, LSTM):
        return CellPlan("lstm", layer.in_dim, layer.hidden, prefix, idx)
    if isinstance(layer, GRU):
        return CellPlan("gru", layer.in_dim, layer.hidden, prefix, idx)
    return None


def cell_step(cp: CellPlan, params, x, h, c=None):
    """One cell step on ``x [N, in]``, ``h``/``c [N, H]``; returns ``(h',
    c')`` (``c'`` is None for a GRU)."""
    wi, wh, b = (params[n] for n in cp.names)
    if cp.kind == "lstm":
        return lstm_cell(x @ wi, h, c, wh, b)
    return gru_cell(x @ wi, h, wh, b), None


@dataclasses.dataclass(frozen=True)
class DRQNPlan:
    in_dim: int
    pre: Tuple[LayerPlan, ...]  # Dense layers before the cell
    cell: CellPlan
    head: FusedPlan             # Dense or dueling head on the cell's h

    @property
    def dense(self) -> Tuple[LayerPlan, ...]:
        """Every Dense layer in kernel order: pre, value head, adv head."""
        return self.pre + self.head.val + self.head.adv

    @property
    def names(self):
        """Parameter keys in kernel order: w, b of each Dense layer, then
        the cell's wi, wh, b."""
        return ([n for lp in self.dense for n in (lp.w_name, lp.b_name)]
                + self.cell.names)

    @functools.lru_cache(maxsize=None)
    def desc(self, T: int) -> build.DrqnDesc:
        """The kernels' ``DrqnDesc`` for trace length ``T`` (built once per
        plan and T; callers must not modify it)."""
        cp, hd = self.cell, self.head
        H, G, A = cp.hidden, cp.n_gates * cp.hidden, hd.num_actions
        d = build.DrqnDesc()
        d.cell = 0 if cp.kind == "lstm" else 1
        d.n_pre, d.n_val, d.n_adv = len(self.pre), len(hd.val), len(hd.adv)
        d.dueling = int(hd.dueling)
        d.in_dim, d.cin, d.H, d.G, d.A, d.T = self.in_dim, cp.in_dim, H, G, A, T
        off = 0
        sizes = []
        for lp in self.dense:
            sizes += [lp.din * lp.dout, lp.dout]
        sizes += [cp.in_dim * G, H * G, G]
        for k, n in enumerate(sizes):
            d.t_off[k], d.t_size[k] = off, n
            off += n
        d.n_params, d.n_tensors = off, len(sizes)
        for l, lp in enumerate(self.dense):
            d.din[l], d.dout[l], d.act[l] = lp.din, lp.dout, _ACTS[lp.act]
            d.off_w[l], d.off_b[l] = d.t_off[2 * l], d.t_off[2 * l + 1]
        nl = len(self.dense)
        d.off_wi, d.off_wh, d.off_bc = (d.t_off[2 * nl], d.t_off[2 * nl + 1],
                                        d.t_off[2 * nl + 2])
        # one step's activations: pre outputs, cell (gates; aux = tanh(c')
        # for LSTM, h·wh of the n gate for GRU; c'; h'), head outputs
        a = 0
        for l, lp in enumerate(self.pre):
            d.off_a[l], a = a, a + lp.dout
        d.a_gates, a = a, a + G
        d.a_aux, a = a, a + H
        d.a_c, a = a, a + (H if cp.kind == "lstm" else 0)
        d.a_h, a = a, a + H
        for l, lp in enumerate(hd.val + hd.adv, start=len(self.pre)):
            d.off_a[l], a = a, a + lp.dout
        d.step_floats = a
        # one warp's region: its gradient accumulators, T step blocks,
        # then scratch
        maxw = max([self.in_dim, cp.in_dim, H] + [lp.dout for lp in self.dense])
        d.s_steps = d.n_params
        s = d.n_params + T * a
        for name, n in (("s_x", self.in_dim), ("s_h2", H), ("s_c2", H),
                        ("s_tmp", a), ("s_q", A), ("s_q2", A), ("s_zero", H),
                        ("s_dht", H), ("s_dhc", H), ("s_dcc", H),
                        ("s_dz", G), ("s_dhh", G), ("s_b0", maxw),
                        ("s_b1", maxw), ("s_gtd", T), ("s_act", T)):
            setattr(d, name, s)
            s += n
        d.warp_floats = s
        return d

    def smem_bytes(self, T: int, warps: int) -> int:
        """Shared memory of one dr_fwd_bwd_kernel block (dr_smem_bytes)."""
        d = self.desc(T)
        return 4 * (d.n_params + warps * (d.warp_floats + 1))

    @functools.lru_cache(maxsize=None)
    def warps_per_block(self, T: int) -> int:
        """Most windows per block (<= MAX_WARPS) within MAX_SMEM; 0 if not
        even one fits."""
        w = MAX_WARPS
        while w > 0 and self.smem_bytes(T, w) > MAX_SMEM:
            w -= 1
        return w


def _split_base(layers, prefix: str):
    """``[Flatten]* [Dense]* (LSTM|GRU)`` -> (pre plans, cell plan)."""
    idx = [(i, l) for i, l in enumerate(layers) if not isinstance(l, Flatten)]
    if not idx:
        return None
    ci, cell = idx[-1]
    cp = cell_plan(cell, f"{prefix}layers.{ci}.", ci)
    pre = dense_plans(idx[:-1], prefix)
    if cp is None or pre is None:
        return None
    return pre, cp


def drqn_plan_for(network, trace_length: int, batch_size: int,
                  double_q: bool = True) -> Optional[DRQNPlan]:
    """A kernel plan if the recurrent network is supported and a window's
    working set fits this card's shared memory, else None."""
    if isinstance(network, DuelingNetwork):
        sb = _split_base(list(network.base.layers), "base.")
        if sb is None:
            return None
        pre, cp = sb
        val = dense_plans(enumerate(network.val.layers), "val.")
        adv = dense_plans(enumerate(network.adv.layers), "adv.")
        if not val or not adv or val[-1].dout != 1:
            return None
        head = FusedPlan(True, cp.hidden, adv[-1].dout, val, adv)
    elif isinstance(network, Chain):
        layers = list(network.layers)
        ci = next((i for i, l in enumerate(layers)
                   if isinstance(l, (LSTM, GRU))), None)
        if ci is None:
            return None
        sb = _split_base(layers[:ci + 1], "")
        adv = dense_plans(list(enumerate(layers))[ci + 1:], "")
        if sb is None or not adv:
            return None
        pre, cp = sb
        head = FusedPlan(False, cp.hidden, adv[-1].dout, (), adv)
    else:
        return None
    in_dim = pre[0].din if pre else cp.in_dim
    chain_ok = all(a.dout == b.din for a, b in zip(pre, pre[1:]))
    if (not chain_ok or (pre and pre[-1].dout != cp.in_dim)
            or head.val and head.val[0].din != cp.hidden
            or head.adv[0].din != cp.hidden):
        return None
    plan = DRQNPlan(in_dim=in_dim, pre=pre, cell=cp, head=head)
    widths = [in_dim, cp.in_dim, cp.hidden] + [lp.dout for lp in plan.dense]
    if (len(plan.dense) > build.DR_MAXL or head.num_actions > MAX_ACTIONS
            or max(widths) > MAX_WIDTH
            or plan.warps_per_block(int(trace_length)) == 0):
        return None
    return plan


# ------------------------------------------------------------ plain version

def _unroll(plan: DRQNPlan, params, xs):
    """Q over a time-major ``[T, N, in_dim]`` sequence from a zero state."""
    T, N = xs.shape[0], xs.shape[1]
    H = plan.cell.hidden
    h = xs.new_zeros(N, H)
    c = xs.new_zeros(N, H) if plan.cell.kind == "lstm" else None
    qs = []
    for t in range(T):
        x = xs[t]
        for lp in plan.pre:
            x = _apply_act(x @ params[lp.w_name] + params[lp.b_name], lp.act)
        h, c = cell_step(plan.cell, params, x, h, c)
        qs.append(q_values(plan.head, params, h)[0])
    return torch.stack(qs)


def _drqn_grads(plan: DRQNPlan, params, obs, nobs, action, reward, done,
                mask, q_sp_tgt, gamma, double_q):
    """One sub-update's loss and gradients (autograd), windows ``[B, T]``."""
    B, T = action.shape
    A = plan.head.num_actions
    tm = lambda x: x.transpose(0, 1)
    with torch.no_grad():
        qsp = tm(q_sp_tgt)
        if double_q:
            best = torch.argmax(_unroll(plan, params, tm(nobs)), dim=-1)
            q_sp_max = torch.gather(qsp, -1, best[..., None])[..., 0]
        else:
            q_sp_max = qsp.max(dim=-1).values
        target = tm(reward) + (1.0 - tm(done)) * gamma * q_sp_max
    p = {k: params[k].detach().requires_grad_() for k in plan.names}
    with torch.enable_grad():
        q = _unroll(plan, p, tm(obs))
        # an action outside [0, A) selects nothing, as the one-hot select
        # of the TPU kernel does
        sel = torch.arange(A, device=q.device) == tm(action)[..., None]
        q_sa = torch.where(sel, q, 0.0).sum(dim=-1)
        loss = huber_loss(tm(mask) * (q_sa - target)).sum() * (1.0 / (B * T))
        grads = torch.autograd.grad(loss, [p[k] for k in plan.names])
    return dict(zip(plan.names, grads)), loss.detach()


def fused_drqn_group_update_plain(plan: DRQNPlan, params, m, v, count, obs,
                                  nobs, action, reward, done, mask, q_sp_tgt,
                                  *, gamma, double_q, lr, batch_size,
                                  n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Plain PyTorch version; same contract as
    :func:`fused_drqn_group_update`."""
    B, U = batch_size, n_updates
    loss = gnorm = None
    t0 = int(count)
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        grads, loss = _drqn_grads(plan, params, obs[sl], nobs[sl],
                                  action[sl].long(), reward[sl], done[sl],
                                  mask[sl], q_sp_tgt[sl], gamma, double_q)
        gnorm = torch.stack([g.abs().max() for g in grads.values()]).max()
        adam_plain(plan.names, params, m, v, grads, t0 + u + 1, lr, b1, b2,
                   adam_eps)
    count.add_(U)
    return loss, gnorm


def fused_drqn_group_update_cuda(plan: DRQNPlan, params, m, v, count, obs,
                                 nobs, action, reward, done, mask, q_sp_tgt,
                                 *, gamma, double_q, lr, batch_size,
                                 n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Launch K5 (2·U kernels on the current stream)."""
    B, U = batch_size, n_updates
    T = action.shape[1]
    A = plan.head.num_actions
    obs, nobs, reward, done, mask, q_sp_tgt = (
        t.float().contiguous()
        for t in (obs, nobs, reward, done, mask, q_sp_tgt))
    action = action.to(torch.int32).contiguous()
    tensors = [params[n] for n in plan.names]
    mt, vt = [m[n] for n in plan.names], [v[n] for n in plan.names]
    build.require_cuda(obs, nobs, action, reward, done, mask, q_sp_tgt,
                       count, *tensors, *mt, *vt)
    if count.dtype != torch.int32:
        raise ValueError("the Adam count must be an int32 tensor")
    d = plan.desc(T)
    for ts in (tensors, mt, vt):
        for k, t in enumerate(ts):
            if t.numel() != d.t_size[k]:
                raise ValueError(f"{plan.names[k]}: {t.numel()} elements, "
                                 f"expected {d.t_size[k]}")
    for name, t in (("obs", obs), ("nobs", nobs)):
        build.require_shape(t, (U * B, T, plan.in_dim), name)
    for name, t in (("action", action), ("reward", reward), ("done", done),
                    ("mask", mask)):
        build.require_shape(t, (U * B, T), name)
    build.require_shape(q_sp_tgt, (U * B, T, A), "q_sp_tgt")
    wpb = plan.warps_per_block(T)
    nblk = -(-B // wpb)
    dev = obs.device
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad = torch.empty(nblk, d.n_params, **f32)
    part_loss = torch.empty(nblk, **f32)
    loss = torch.empty((), **f32)
    gnorm = torch.empty((), **f32)
    ptrs = lambda ts: build.int64_array([t.data_ptr() for t in ts])
    err = build.library().dq_fused_drqn(
        d, ptrs(tensors), ptrs(mt), ptrs(vt), count.data_ptr(), U, B, wpb,
        obs.data_ptr(), nobs.data_ptr(), action.data_ptr(),
        reward.data_ptr(), done.data_ptr(), mask.data_ptr(),
        q_sp_tgt.data_ptr(), gamma, int(bool(double_q)), lr, b1, b2,
        adam_eps, part_grad.data_ptr(),
        part_loss.data_ptr(), loss.data_ptr(), gnorm.data_ptr(),
        build.stream_ptr(dev))
    build.check(err, "fused_drqn_group_update")
    fused_drqn_group_update_cuda.launches += 1
    count.add_(U)
    return loss, gnorm


fused_drqn_group_update_cuda.launches = 0


def fused_drqn_group_update(plan: DRQNPlan, params, m, v, count, obs, nobs,
                            action, reward, done, mask, q_sp_tgt, *, gamma,
                            double_q, lr, batch_size, n_updates, b1=0.9,
                            b2=0.999, adam_eps=1e-8):
    """Run U fused recurrent sub-updates IN PLACE on ``params``/``m``/``v``
    (dicts keyed as ``plan.names``) and ``count`` (int32 scalar tensor).

    Windows are u-major, ``N = U·B`` of them: ``obs``/``nobs [N, T, *obs]``
    (``nobs`` unused without double-Q), ``action [N, T]`` int,
    ``reward``/``done``/``mask [N, T]``, ``q_sp_tgt [N, T, A]`` the target
    net's Q(s') from a zero-state unroll. Returns ``(loss, gnorm)`` of the
    last sub-update."""
    _check_windows(batch_size * n_updates, obs, nobs, action, reward, done,
                   mask, q_sp_tgt)
    fn = (fused_drqn_group_update_cuda if obs.is_cuda
          else fused_drqn_group_update_plain)
    flat = lambda x: x.reshape(x.shape[0], x.shape[1], -1)
    return fn(plan, params, m, v, count, flat(obs), flat(nobs), action,
              reward, done, mask, q_sp_tgt, gamma=gamma, double_q=double_q,
              lr=lr, batch_size=batch_size, n_updates=n_updates, b1=b1,
              b2=b2, adam_eps=adam_eps)


# ------------------------------- K8: one recurrent sub-update, emitting grads

def fused_drqn_grads_plain(plan: DRQNPlan, params, obs, nobs, action, reward,
                           done, mask, q_sp_tgt, *, gamma, double_q):
    """Plain PyTorch version of :func:`fused_drqn_grads`, returning the
    flat gradient ``[n_params]`` in place of the dict."""
    grads, loss = _drqn_grads(plan, params, obs, nobs, action.long(), reward,
                              done, mask, q_sp_tgt, gamma, double_q)
    flat = flatten(grads, plan.names)
    return flat, loss, flat.abs().max()


def _k8_inputs(plan: DRQNPlan, params, n, obs, nobs, action, reward, done,
               mask, q_sp_tgt):
    """K8's inputs of ``n`` windows as contiguous f32 (int32 actions) CUDA
    tensors, checked against the plan; the parameter tensors in plan
    order; and the kernels' descriptor."""
    T = action.shape[1]
    obs, nobs, reward, done, mask, q_sp_tgt = (
        t.float().contiguous()
        for t in (obs, nobs, reward, done, mask, q_sp_tgt))
    action = action.to(torch.int32).contiguous()
    tensors = [params[k] for k in plan.names]
    build.require_cuda(obs, nobs, action, reward, done, mask, q_sp_tgt,
                       *tensors)
    d = plan.desc(T)
    for k, t in enumerate(tensors):
        if t.numel() != d.t_size[k]:
            raise ValueError(f"{plan.names[k]}: {t.numel()} elements, "
                             f"expected {d.t_size[k]}")
    for name, t in (("obs", obs), ("nobs", nobs)):
        build.require_shape(t, (n, T, plan.in_dim), name)
    for name, t in (("action", action), ("reward", reward), ("done", done),
                    ("mask", mask)):
        build.require_shape(t, (n, T), name)
    build.require_shape(q_sp_tgt, (n, T, plan.head.num_actions), "q_sp_tgt")
    return (obs, nobs, action, reward, done, mask, q_sp_tgt), tensors, d


def fused_drqn_grads_cuda(plan: DRQNPlan, params, obs, nobs, action, reward,
                          done, mask, q_sp_tgt, *, gamma, double_q):
    """Launch K8 (two kernels on the current stream); returns what
    :func:`fused_drqn_grads_plain` returns."""
    B, T = action.shape
    xs, tensors, d = _k8_inputs(plan, params, B, obs, nobs, action, reward,
                                done, mask, q_sp_tgt)
    wpb = plan.warps_per_block(T)
    f32 = dict(dtype=torch.float32, device=xs[0].device)
    part_grad = torch.empty(-(-B // wpb), d.n_params, **f32)
    part_loss = torch.empty(part_grad.shape[0], **f32)
    flat = torch.empty(d.n_params, **f32)
    loss, gnorm = torch.empty((), **f32), torch.empty((), **f32)
    err = build.library().dq_fused_drqn_grads(
        d, build.int64_array([t.data_ptr() for t in tensors]), B, wpb,
        *(x.data_ptr() for x in xs), gamma, int(bool(double_q)),
        part_grad.data_ptr(), part_loss.data_ptr(), flat.data_ptr(),
        loss.data_ptr(), gnorm.data_ptr(), build.stream_ptr(flat.device))
    build.check(err, "fused_drqn_grads")
    fused_drqn_grads_cuda.launches += 1
    return flat, loss, gnorm


fused_drqn_grads_cuda.launches = 0


def _check_windows(n, obs, nobs, action, reward, done, mask, q_sp_tgt):
    for name, t in (("obs", obs), ("nobs", nobs), ("action", action),
                    ("reward", reward), ("done", done), ("mask", mask),
                    ("q_sp_tgt", q_sp_tgt)):
        if t.shape[0] != n or t.shape[1] != action.shape[1]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"[{n}, {action.shape[1]}, ...]")


def fused_drqn_grads(plan: DRQNPlan, params, obs, nobs, action, reward, done,
                     mask, q_sp_tgt, *, gamma, double_q):
    """One recurrent sub-update's unrolls, masked TD loss and BPTT on ``B``
    windows, params read only: ``obs``/``nobs [B, T, *obs]``, ``action``/
    ``reward``/``done``/``mask [B, T]``, ``q_sp_tgt [B, T, A]``. Returns
    ``(grads, loss, gnorm)``, the contract of the JAX ``fused_drqn_grads``:
    ``grads`` are views of one flat f32 gradient in ``plan.names`` order
    (which ``fused_drqn_grads_cuda``/``_plain`` return), ``gnorm`` the
    local max-abs."""
    _check_windows(action.shape[0], obs, nobs, action, reward, done, mask,
                   q_sp_tgt)
    fn = fused_drqn_grads_cuda if obs.is_cuda else fused_drqn_grads_plain
    flat3 = lambda x: x.reshape(x.shape[0], x.shape[1], -1)
    flat, loss, gnorm = fn(plan, params, flat3(obs), flat3(nobs), action,
                           reward, done, mask, q_sp_tgt, gamma=gamma,
                           double_q=double_q)
    return unflatten(flat, params, plan.names), loss, gnorm


# ----------------- the data-parallel recurrent update: K8, reduce, Adam

def fused_drqn_dp_group_update_plain(plan: DRQNPlan, params, m, v, count,
                                     obs, nobs, action, reward, done, mask,
                                     q_sp_tgt, *, reduce, gamma, double_q,
                                     lr, batch_size, n_updates, b1=0.9,
                                     b2=0.999, adam_eps=1e-8):
    """Plain PyTorch version; same contract as
    :func:`fused_drqn_dp_group_update`."""
    B, U = batch_size, n_updates
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        flat, loss, _ = fused_drqn_grads_plain(
            plan, params, obs[sl], nobs[sl], action[sl], reward[sl],
            done[sl], mask[sl], q_sp_tgt[sl], gamma=gamma, double_q=double_q)
        reduce(flat)
        gnorm = adam_flat_plain(plan.names, params, m, v, count, flat, u=u,
                                lr=lr, b1=b1, b2=b2, adam_eps=adam_eps)
    count.add_(U)
    return loss, gnorm


def fused_drqn_dp_group_update_cuda(plan: DRQNPlan, params, m, v, count,
                                    obs, nobs, action, reward, done, mask,
                                    q_sp_tgt, *, reduce, gamma, double_q, lr,
                                    batch_size, n_updates, b1=0.9, b2=0.999,
                                    adam_eps=1e-8):
    """Per sub-update on the current stream: K8 (two launches), ``reduce``
    of its flat gradient, and K5's one-block Adam kernel on that vector;
    checks and allocations once for all U sub-updates."""
    B, U = batch_size, n_updates
    T = action.shape[1]
    xs, tensors, d = _k8_inputs(plan, params, U * B, obs, nobs, action,
                                reward, done, mask, q_sp_tgt)
    mt, vt = [m[k] for k in plan.names], [v[k] for k in plan.names]
    build.require_cuda(count, *mt, *vt)
    if count.dtype != torch.int32:
        raise ValueError("the Adam count must be an int32 tensor")
    for ts in (mt, vt):
        for k, t in enumerate(ts):
            if t.numel() != d.t_size[k]:
                raise ValueError(f"{plan.names[k]}: {t.numel()} elements, "
                                 f"expected {d.t_size[k]}")
    wpb = plan.warps_per_block(T)
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad = torch.empty(-(-B // wpb), d.n_params, **f32)
    part_loss = torch.empty(part_grad.shape[0], **f32)
    flat = torch.empty(U, d.n_params, **f32)
    loss, lgn, gnorm = (torch.empty(U, **f32) for _ in range(3))
    ptrs = lambda ts: build.int64_array([t.data_ptr() for t in ts])
    P, M, V = ptrs(tensors), ptrs(mt), ptrs(vt)
    lib, stream = build.library(), build.stream_ptr(dev)
    # sub-batch u starts u·B windows into each input; elements are 4 bytes
    rows = [(x.data_ptr(), 4 * B * x[0].numel()) for x in xs]
    scratch = part_grad.data_ptr(), part_loss.data_ptr()
    per_u = [(t.data_ptr(), 4 * k) for t, k in ((flat, d.n_params),
                                                 (loss, 1), (lgn, 1))]
    dq, cnt, g_out = int(bool(double_q)), count.data_ptr(), gnorm.data_ptr()
    for u in range(U):
        err = lib.dq_fused_drqn_grads(
            d, P, B, wpb, *(base + u * step for base, step in rows), gamma,
            dq, *scratch, *(base + u * step for base, step in per_u), stream)
        build.check(err, "fused_drqn_grads")
        fused_drqn_grads_cuda.launches += 1
        reduce(flat[u])
        err = lib.dq_drqn_adam(d, P, M, V, cnt, u, per_u[0][0] +
                               u * per_u[0][1], lr, b1, b2, adam_eps,
                               g_out + 4 * u, stream)
        build.check(err, "fused_drqn_dp_group_update (Adam)")
    fused_drqn_dp_group_update_cuda.launches += 1
    count.add_(U)
    return loss[U - 1], gnorm[U - 1]


fused_drqn_dp_group_update_cuda.launches = 0


def fused_drqn_dp_group_update(plan: DRQNPlan, params, m, v, count, obs,
                               nobs, action, reward, done, mask, q_sp_tgt, *,
                               reduce, gamma, double_q, lr, batch_size,
                               n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """U data-parallel recurrent sub-updates IN PLACE on ``params``/``m``/
    ``v`` and ``count``, with the inputs of :func:`fused_drqn_group_update`.
    Per sub-update u: K8 on windows ``[u·B, (u+1)·B)``, ``reduce(flat)``
    on its flat gradient (in place: the all-reduce), then Adam at ``t =
    count + u + 1`` from that vector. Returns ``(loss, gnorm)``: the last
    sub-update's local loss and the max-abs of its reduced gradient."""
    _check_windows(batch_size * n_updates, obs, nobs, action, reward, done,
                   mask, q_sp_tgt)
    fn = fused_drqn_dp_group_update_cuda if obs.is_cuda else \
        fused_drqn_dp_group_update_plain
    flat3 = lambda x: x.reshape(x.shape[0], x.shape[1], -1)
    return fn(plan, params, m, v, count, flat3(obs), flat3(nobs), action,
              reward, done, mask, q_sp_tgt, reduce=reduce, gamma=gamma,
              double_q=double_q, lr=lr, batch_size=batch_size,
              n_updates=n_updates, b1=b1, b2=b2, adam_eps=adam_eps)
