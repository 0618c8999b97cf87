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

On the card: ONE cooperative launch per grouped call on the current
stream, whose blocks loop over the U sub-updates with two grid barriers
each: (A) tiles of ``plan.desc(T).tile`` windows (``TILE``, fewer for wide
nets) advance together step by step, the s and s' unrolls as rows of one
block-wide step, then BPTT; one partial gradient per tile ``[ceil(B/tile),
n_params]``; (B) one thread per parameter sums the tile partials in tile
order and applies Adam (K3's phase B). Every sum has a fixed order, so runs
are bit-identical whatever the grid. The grid is the card's co-resident
block count for the plan (cached per plan and T), capped at the work.

K8 (:func:`fused_drqn_grads`) replaces ``fused_drqn_grads`` of the same
JAX file: the same kernel with U = 1 on one sub-batch of B windows, writing
the tile-order sum as one flat gradient in ``plan.names`` order, with the
loss and the local max-abs, in place of Adam.
:func:`fused_drqn_dp_group_update` is the data-parallel step's U
sub-updates: per sub-update K8, a caller's reduce of the flat vector in
place, and a multi-block Adam launch on it with phase B's arithmetic; with
a reduce that leaves the vector as it is, that is K5's update bit for bit.

:func:`fused_drqn_group_update_tiled` and :func:`fused_drqn_grads_tiled`
are plain references in the kernel's sum order (per-tile partials summed in
tile order), held against the JAX kernel on the CPU and against K5/K8 on
the card at a tighter tolerance than the autograd twins'.

:func:`drqn_plan_for` is the gate, on the network family of the JAX
kernel: ``[Flatten]* [Dense]* LSTM|GRU`` and a Dense or dueling head with a
scalar value head, with this card's limits in place of the TPU's VMEM
budget: every width at most ``MAX_WIDTH``, at most ``MAX_ACTIONS`` actions
and ``build.DR_MAXL`` Dense layers, and a block's padded params and
per-window state of one window within ``MAX_SMEM`` bytes of shared memory
(the tiles' T-step regions move to global scratch when they do not fit).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ...models.chain import GRU, LSTM, Chain, Flatten, gru_cell, lstm_cell
from ...models.dueling import DuelingNetwork
from ...ops.helpers import flatten, huber_loss, select_action, unflatten
from . import build
from .fused_update import (
    _ACTS, MAX_ACTIONS, MAX_SMEM, FusedPlan, LayerPlan, _apply_act,
    _tile_order_sum, adam_flat_plain, adam_plain, dense_plans, q_values)

MAX_WIDTH = 256
_r4 = lambda n: -(-n // 4) * 4  # n rounded up to whole float4s
TILE = 4  # windows per tile of K5/K8 where they fit (fewer for wide nets)
THREADS = 512  # DR_THREADS of csrc/fused_drqn.cu


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
        plan and T; callers must not modify it): the packed and the padded
        shared parameter layouts, the step, cotangent and T-step region
        layouts, and the tile. ``tile`` is 0 when not even one window's
        shared part fits ``MAX_SMEM``."""
        cp, hd = self.cell, self.head
        H, G, A, D = cp.hidden, cp.n_gates * cp.hidden, hd.num_actions, \
            self.in_dim
        d = build.DrqnDesc()
        d.cell = 0 if cp.kind == "lstm" else 1
        d.n_pre, d.n_val, d.n_adv = len(self.pre), len(hd.val), len(hd.adv)
        d.dueling = int(hd.dueling)
        d.in_dim, d.cin, d.H, d.G, d.A, d.T = D, cp.in_dim, H, G, A, T
        # packed tensors, and their shared copy: each weight matrix 16-byte
        # aligned with a row stride of 4 (mod 8) floats (float4 reads of
        # eight consecutive rows hit distinct banks), each bias flat
        tensors = []
        for lp in self.dense:
            tensors += [(lp.din, lp.dout, True), (1, lp.dout, False)]
        tensors += [(cp.in_dim, G, True), (H, G, True), (1, G, False)]
        off = dst = items = 0
        for k, (rows, cols, matrix) in enumerate(tensors):
            ld = cols + (4 - cols) % 8 if matrix else 0
            dst = _r4(dst) if matrix else dst
            d.t_off[k], d.t_size[k] = off, rows * cols
            d.t_dst[k], d.t_ld[k], d.t_cols[k] = dst, ld, cols
            d.w_start[k] = items  # the gradient pass: 4 x 4 entries each
            off += rows * cols
            dst += rows * ld if matrix else cols
            items += -(-rows // 4) * -(-cols // 4)
        d.n_params, d.n_tensors = off, len(tensors)
        d.w_start[len(tensors)] = d.n_witems = items
        d.n_sp = _r4(dst)  # whole float4s for the staged copy
        nl = len(self.dense)
        for l, lp in enumerate(self.dense):
            d.din[l], d.dout[l], d.act[l] = lp.din, lp.dout, _ACTS[lp.act]
            d.off_w[l], d.off_b[l] = d.t_off[2 * l], d.t_off[2 * l + 1]
            d.sw[l], d.ldw[l] = d.t_dst[2 * l], d.t_ld[2 * l]
            d.sb[l] = d.t_dst[2 * l + 1]
        d.off_wi, d.off_wh, d.off_bc = (d.t_off[2 * nl], d.t_off[2 * nl + 1],
                                        d.t_off[2 * nl + 2])
        d.s_wi, d.ld_wi = d.t_dst[2 * nl], d.t_ld[2 * nl]
        d.s_wh, d.ld_wh = d.t_dst[2 * nl + 1], d.t_ld[2 * nl + 1]
        d.s_bc = d.t_dst[2 * nl + 2]
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
        d.step_floats = SF = a
        # each layer's input in a step block (-1: the observation)
        npre, nv = len(self.pre), len(hd.val)
        for l in range(nl):
            d.in_a[l] = (d.a_h if l in (npre, npre + nv)
                         else -1 if l == 0 else d.off_a[l - 1])
        d.cell_in = d.off_a[npre - 1] if npre else -1
        # one step's cotangents, each 16-byte aligned: each Dense layer's
        # dz, the gates' dz, the GRU gates' recurrent-side dg
        c = 0
        for l, lp in enumerate(self.dense):
            d.off_d[l], c = c, c + _r4(lp.dout)
        d.d_gates, c = c, c + _r4(G)
        if cp.kind == "gru":
            d.d_dg, c = c, c + _r4(G)
        else:
            d.d_dg = d.d_gates
        d.cot_floats = c
        # a window's T-step region
        r = 0
        for name, n in (("r_cot", T * c), ("r_steps", T * SF),
                        ("r_x", T * D), ("r_x2", T * D), ("r_tgt", T * A),
                        ("r_rew", T), ("r_done", T), ("r_mask", T),
                        ("r_act", T), ("r_hub", T)):
            setattr(d, name, r)
            r += n
        d.region_floats = r = _r4(r)
        # the tile: the most windows (TILE, TILE/2, ... 1) whose regions fit
        # beside the params, s' step blocks, state and xT / hT; else the
        # regions go to global scratch
        def fixed(w):
            f_xt = _r4(d.n_sp + 2 * w * SF + 3 * w * H) + 2 * H * _r4(2 * w)
            return _r4(f_xt + 2 * cp.in_dim * _r4(2 * w))
        tiles = [TILE >> i for i in range(TILE.bit_length())]
        limit = MAX_SMEM // 4
        W, glob = next(((w, 0) for w in tiles if fixed(w) + w * r <= limit),
                       next(((w, 1) for w in tiles if fixed(w) <= limit),
                            (0, 1)))
        d.tile, d.act_global, d.rp = W, glob, _r4(2 * W)
        d.f_sp2 = d.n_sp
        d.f_state = d.f_sp2 + 2 * W * SF
        d.f_ht = _r4(d.f_state + 3 * W * H)
        d.f_xt = d.f_ht + 2 * H * d.rp  # hT and xT: one per step parity
        d.f_region = _r4(d.f_xt + 2 * cp.in_dim * d.rp)
        d.smem_floats = max(d.f_region + (0 if glob else W * r), THREADS)
        return d

    def smem_bytes(self, T: int) -> int:
        """Shared memory of one K5/K8 block (``smem_floats``): the padded
        params, two s' step blocks and three H-wide BPTT states per window,
        the rows' h and cell input feature-major, and, unless in
        global scratch, the windows' T-step regions; at least one float per
        thread (phase B's block max)."""
        return 4 * self.desc(T).smem_floats


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
    """A kernel plan if the recurrent network is supported and a block's
    params and one window's state fit this card's shared memory, else
    None."""
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
            or plan.desc(int(trace_length)).tile == 0):
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
                mask, q_sp_tgt, gamma, double_q, inv=None):
    """One sub-update's gradients (autograd) on windows ``[B, T]`` of the
    loss ``huber_sum · inv`` (``inv`` 1/(B·T) by default); returns them with
    the windows' Huber sum."""
    B, T = action.shape
    inv = 1.0 / (B * T) if inv is None else inv
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
        q_sa = select_action(q, tm(action))
        hsum = huber_loss(tm(mask) * (q_sa - target)).sum()
        grads = torch.autograd.grad(hsum * inv, [p[k] for k in plan.names])
    return dict(zip(plan.names, grads)), hsum.detach()


def _group_update(grads_fn, plan: DRQNPlan, params, m, v, count, obs, nobs,
                  action, reward, done, mask, q_sp_tgt, *, gamma, double_q,
                  lr, batch_size, n_updates, b1, b2, adam_eps):
    """U sub-updates in place: ``grads_fn`` (a plain version of K8) on
    each sub-update's B windows, then Adam at ``count + u + 1``; returns
    the last sub-update's loss and gnorm."""
    B, U = batch_size, n_updates
    loss = gnorm = None
    t0 = count.to(torch.int64)
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        flat, loss, gnorm = grads_fn(
            plan, params, obs[sl], nobs[sl], action[sl], reward[sl],
            done[sl], mask[sl], q_sp_tgt[sl], gamma=gamma, double_q=double_q)
        adam_plain(plan.names, params, m, v,
                   unflatten(flat, params, plan.names), t0 + (u + 1), lr, b1,
                   b2, adam_eps)
    count.add_(U)
    return loss, gnorm


def fused_drqn_group_update_plain(plan: DRQNPlan, params, m, v, count, obs,
                                  nobs, action, reward, done, mask, q_sp_tgt,
                                  *, gamma, double_q, lr, batch_size,
                                  n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Plain PyTorch version; same contract as
    :func:`fused_drqn_group_update`."""
    return _group_update(
        fused_drqn_grads_plain, plan, params, m, v, count, obs, nobs, action,
        reward, done, mask, q_sp_tgt, gamma=gamma, double_q=double_q, lr=lr,
        batch_size=batch_size, n_updates=n_updates, b1=b1, b2=b2,
        adam_eps=adam_eps)


def tile_partials(plan: DRQNPlan, params, obs, nobs, action, reward, done,
                  mask, q_sp_tgt, *, gamma, double_q):
    """K5's and K8's partials in plain PyTorch: each tile of
    ``plan.desc(T).tile`` windows' flat gradient of the batch's loss (its
    Huber sum times 1/(B·T)), ``[ceil(B/tile), n_params]``, and its Huber
    sum ``[ceil(B/tile)]``."""
    B, T = action.shape
    tile = plan.desc(T).tile
    parts, hubs = [], []
    for w0 in range(0, B, tile):
        sl = slice(w0, w0 + tile)
        grads, hsum = _drqn_grads(plan, params, obs[sl], nobs[sl],
                                  action[sl].long(), reward[sl], done[sl],
                                  mask[sl], q_sp_tgt[sl], gamma, double_q,
                                  inv=1.0 / (B * T))
        parts.append(flatten(grads, plan.names))
        hubs.append(hsum)
    return torch.stack(parts), torch.stack(hubs)


def fused_drqn_grads_tiled(plan: DRQNPlan, params, obs, nobs, action, reward,
                           done, mask, q_sp_tgt, *, gamma, double_q):
    """Plain reference of K8 in the kernel's sum order; returns what
    :func:`fused_drqn_grads_plain` returns: the tile partials summed in tile
    order, the tiles' Huber sums likewise times 1/(B·T), and the sum's
    max-abs entry."""
    B, T = action.shape
    parts, hubs = tile_partials(plan, params, obs, nobs, action, reward,
                                done, mask, q_sp_tgt, gamma=gamma,
                                double_q=double_q)
    flat = _tile_order_sum(parts)
    return flat, _tile_order_sum(hubs) * (1.0 / (B * T)), flat.abs().max()


def fused_drqn_group_update_tiled(plan: DRQNPlan, params, m, v, count, obs,
                                  nobs, action, reward, done, mask, q_sp_tgt,
                                  *, gamma, double_q, lr, batch_size,
                                  n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Plain reference of K5 in the kernel's sum order; same contract as
    :func:`fused_drqn_group_update`. Per sub-update:
    :func:`fused_drqn_grads_tiled`, then Adam."""
    return _group_update(
        fused_drqn_grads_tiled, plan, params, m, v, count, obs, nobs, action,
        reward, done, mask, q_sp_tgt, gamma=gamma, double_q=double_q, lr=lr,
        batch_size=batch_size, n_updates=n_updates, b1=b1, b2=b2,
        adam_eps=adam_eps)


def partials(plan: DRQNPlan, T: int, B: int, device):
    """K5's and K8's scratch: one partial gradient and one Huber sum per
    tile, ``([ceil(B/tile), n_params], [ceil(B/tile)])``, indexed by tile
    whatever the grid."""
    d = plan.desc(T)
    nt = -(-B // d.tile)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(nt, d.n_params, **f32), torch.empty(nt, **f32))


_MAX_GRID: Dict[Tuple[DRQNPlan, int, int], int] = {}


def launch_grid(plan: DRQNPlan, T: int, B: int, device) -> int:
    """Blocks of one K5/K8 cooperative launch: the card's co-resident block
    count for this plan and T (asked once per plan, T and device), capped
    at the work: the tiles of phase A or one thread per parameter in phase
    B, whichever needs more blocks."""
    dev = torch.device(device)
    key = (plan, T, torch.cuda.current_device() if dev.index is None
           else dev.index)
    if key not in _MAX_GRID:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            build.check(build.library().dq_fused_drqn_max_grid(
                plan.desc(T), ctypes.byref(out)), "fused_drqn (grid)")
        _MAX_GRID[key] = out.value
    d = plan.desc(T)
    need = max(-(-B // d.tile), -(-d.n_params // THREADS))
    return min(_MAX_GRID[key], need)


def _act_scratch(plan: DRQNPlan, T: int, grid: int, device):
    """The blocks' T-step regions in global memory when they do not fit
    shared memory (``desc.act_global``), else None."""
    d = plan.desc(T)
    if not d.act_global:
        return None
    return torch.empty(grid * d.tile * d.region_floats, dtype=torch.float32,
                       device=device)


def _k5_inputs(plan: DRQNPlan, params, n, obs, nobs, action, reward, done,
               mask, q_sp_tgt):
    """K5's and K8's inputs of ``n`` windows as contiguous f32 (int32
    actions) CUDA tensors, checked against the plan; the parameter tensors
    in plan order; and the kernels' descriptor."""
    T = action.shape[1]
    obs, nobs, reward, done, mask, q_sp_tgt = (
        t.float().contiguous()
        for t in (obs, nobs, reward, done, mask, q_sp_tgt))
    action = action.to(torch.int32).contiguous()
    tensors = [params[k] for k in plan.names]
    build.require_cuda(obs, nobs, action, reward, done, mask, q_sp_tgt,
                       *tensors)
    d = plan.desc(T)
    _require_sizes(plan, d, tensors)
    for name, t in (("obs", obs), ("nobs", nobs)):
        build.require_shape(t, (n, T, plan.in_dim), name)
    for name, t in (("action", action), ("reward", reward), ("done", done),
                    ("mask", mask)):
        build.require_shape(t, (n, T), name)
    build.require_shape(q_sp_tgt, (n, T, plan.head.num_actions), "q_sp_tgt")
    return (obs, nobs, action, reward, done, mask, q_sp_tgt), tensors, d


def _require_sizes(plan: DRQNPlan, d, tensors):
    for k, t in enumerate(tensors):
        if t.numel() != d.t_size[k]:
            raise ValueError(f"{plan.names[k]}: {t.numel()} elements, "
                             f"expected {d.t_size[k]}")


def _adam_state(plan: DRQNPlan, d, m, v, count):
    """The moments in plan order, checked, and the int32 CUDA count."""
    mt, vt = [m[k] for k in plan.names], [v[k] for k in plan.names]
    build.require_cuda(count, *mt, *vt)
    if count.dtype != torch.int32:
        raise ValueError("the Adam count must be an int32 tensor")
    _require_sizes(plan, d, mt)
    _require_sizes(plan, d, vt)
    return mt, vt


_ptrs = lambda ts: build.int64_array([t.data_ptr() for t in ts])
_ptr = lambda t: None if t is None else t.data_ptr()


def fused_drqn_group_update_cuda(plan: DRQNPlan, params, m, v, count, obs,
                                 nobs, action, reward, done, mask, q_sp_tgt,
                                 *, gamma, double_q, lr, batch_size,
                                 n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Launch K5 (one cooperative kernel on the current stream)."""
    B, U = batch_size, n_updates
    T = action.shape[1]
    xs, tensors, d = _k5_inputs(plan, params, U * B, obs, nobs, action,
                                reward, done, mask, q_sp_tgt)
    mt, vt = _adam_state(plan, d, m, v, count)
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad, part_loss = partials(plan, T, B, dev)
    stage = torch.empty(d.n_sp, **f32)
    loss, gnorm = torch.empty((), **f32), torch.empty((), **f32)
    grid = launch_grid(plan, T, B, dev)
    err = build.library().dq_fused_drqn(
        d, _ptrs(tensors), _ptrs(mt), _ptrs(vt), count.data_ptr(), U, B,
        *(x.data_ptr() for x in xs), gamma, int(bool(double_q)), lr, b1, b2,
        adam_eps, part_grad.data_ptr(), part_loss.data_ptr(),
        loss.data_ptr(), gnorm.data_ptr(), stage.data_ptr(),
        _ptr(_act_scratch(plan, T, grid, dev)), grid, build.stream_ptr(dev))
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
    B, T = action.shape
    grads, hsum = _drqn_grads(plan, params, obs, nobs, action.long(), reward,
                              done, mask, q_sp_tgt, gamma, double_q)
    flat = flatten(grads, plan.names)
    return flat, hsum * (1.0 / (B * T)), flat.abs().max()


def fused_drqn_grads_cuda(plan: DRQNPlan, params, obs, nobs, action, reward,
                          done, mask, q_sp_tgt, *, gamma, double_q):
    """Launch K8 (one cooperative kernel on the current stream); returns
    what :func:`fused_drqn_grads_plain` returns."""
    B, T = action.shape
    xs, tensors, d = _k5_inputs(plan, params, B, obs, nobs, action, reward,
                                done, mask, q_sp_tgt)
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad, part_loss = partials(plan, T, B, dev)
    flat = torch.empty(d.n_params, **f32)
    loss, gnorm = torch.empty((), **f32), torch.empty((), **f32)
    grid = launch_grid(plan, T, B, dev)
    err = build.library().dq_fused_drqn_grads(
        d, _ptrs(tensors), B, *(x.data_ptr() for x in xs), gamma,
        int(bool(double_q)), part_grad.data_ptr(), part_loss.data_ptr(),
        flat.data_ptr(), loss.data_ptr(), gnorm.data_ptr(),
        _ptr(_act_scratch(plan, T, grid, dev)), grid, build.stream_ptr(dev))
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
    """Per sub-update on the current stream: K8 (one cooperative launch),
    ``reduce`` of its flat gradient, and the Adam launch on that vector;
    checks and allocations once for all U sub-updates."""
    B, U = batch_size, n_updates
    T = action.shape[1]
    xs, tensors, d = _k5_inputs(plan, params, U * B, obs, nobs, action,
                                reward, done, mask, q_sp_tgt)
    mt, vt = _adam_state(plan, d, m, v, count)
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad, part_loss = partials(plan, T, B, dev)
    flat = torch.empty(U, d.n_params, **f32)
    loss, lgn, gnorm = (torch.empty(U, **f32) for _ in range(3))
    P, M, V = _ptrs(tensors), _ptrs(mt), _ptrs(vt)
    lib, stream = build.library(), build.stream_ptr(dev)
    grid = launch_grid(plan, T, B, dev)
    act = _ptr(_act_scratch(plan, T, grid, dev))
    # sub-batch u starts u·B windows into each input; elements are 4 bytes
    rows = [(x.data_ptr(), 4 * B * x[0].numel()) for x in xs]
    scratch = part_grad.data_ptr(), part_loss.data_ptr()
    per_u = [(t.data_ptr(), 4 * k) for t, k in ((flat, d.n_params),
                                                 (loss, 1), (lgn, 1))]
    dq, cnt, g_out = int(bool(double_q)), count.data_ptr(), gnorm.data_ptr()
    for u in range(U):
        err = lib.dq_fused_drqn_grads(
            d, P, B, *(base + u * step for base, step in rows), gamma, dq,
            *scratch, *(base + u * step for base, step in per_u), act, grid,
            stream)
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
