"""K3: the grouped train phase, U sequential sub-updates, and K7: one
sub-update emitting gradients, for data parallelism (``csrc/fused_update.cu``).

Replaces ``fused_group_update`` of ``deepqlearning_tpu/ops/pallas/
fused_update.py``. Each sub-update u takes rows ``[u·B, (u+1)·B)`` of the
u-major sample: the dueling (or plain) Dense forward on s and, for double-Q,
on s' for the argmax; the TD loss against the precomputed target-net
Q(s'); the hand-derived backward; Adam with bias correction at
``t = count + u + 1``. Params, m and v are updated IN PLACE, and ``count``
advances by U in place.

On the card: ONE cooperative launch per grouped call on the current
stream, whose blocks loop over the U sub-updates with two grid barriers
each: (A) tiles of ``TILE`` rows, forward/TD/backward, one partial gradient
per tile ``[ceil(B/TILE), n_params]``; (B) one thread per parameter sums
the tile partials in tile order and applies Adam. Every sum has a fixed
order, so runs are bit-identical whatever the grid. The grid is the card's
co-resident block count for the plan (cached per plan), capped at the work
(see the source).

K7 (:func:`fused_grads`) replaces ``fused_grads`` of the same JAX file:
the same kernel with U = 1 on one sub-batch of B rows, writing the
tile-order sum as one flat gradient in ``plan.names`` order, with the loss
and the local max-abs, in place of Adam.
:func:`fused_dp_group_update` is the data-parallel step's U sub-updates:
per sub-update K7, a caller's reduce (the all-reduce) of that flat vector
in place, and one multi-block Adam launch on the reduced vector with K3's
Adam arithmetic; with a reduce that leaves the vector as it is, that is
K3's update bit for bit.

:func:`fused_group_update_tiled` is a plain reference with the kernel's
sum order (per-tile partials summed in tile order), held against the JAX
kernel on the CPU and against K3 on the card at a tighter tolerance than
the twin's.

:func:`plan_for` is the gate, as in the JAX package: a dueling or plain
stack of Dense layers with tanh/relu/identity and bias, a scalar value head,
every layer at most ``MAX_WIDTH`` wide, at most ``MAX_ACTIONS`` actions and
``MAX_LAYERS`` Dense layers, and a block's shared memory within
``MAX_SMEM`` bytes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...models.chain import Chain, Dense, Flatten
from ...models.dueling import DuelingNetwork
from ..helpers import action_mask, flatten, select_action, unflatten
from . import build

MAX_WIDTH = 256
MAX_ACTIONS = 128
MAX_LAYERS = build.MAXL
MAX_SMEM = 200 * 1024
TILE = 4  # FU_TILE of csrc/fused_update.cu: rows per tile
THREADS = 512  # FU_THREADS
_ACTS = {"id": 0, "tanh": 1, "relu": 2}


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    din: int
    dout: int
    act: str      # 'id' | 'tanh' | 'relu'
    w_name: str   # parameter dict keys
    b_name: str


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    dueling: bool
    in_dim: int
    num_actions: int
    val: Tuple[LayerPlan, ...]  # () when not dueling
    adv: Tuple[LayerPlan, ...]  # the main chain when not dueling

    @property
    def layers(self) -> Tuple[LayerPlan, ...]:
        return self.val + self.adv

    @property
    def names(self):
        """Parameter keys in kernel order: w0, b0, w1, b1, ..."""
        return [n for lp in self.layers for n in (lp.w_name, lp.b_name)]

    @functools.lru_cache(maxsize=None)
    def desc(self) -> build.NetDesc:
        """The kernels' ``NetDesc`` for this plan (built once per plan;
        callers must not modify it)."""
        d = build.NetDesc()
        d.dueling = int(self.dueling)
        d.n_val, d.n_adv = len(self.val), len(self.adv)
        d.in_dim, d.num_actions = self.in_dim, self.num_actions
        off = off_h = 0
        maxw = self.in_dim
        for l, lp in enumerate(self.layers):
            d.din[l], d.dout[l], d.act[l] = lp.din, lp.dout, _ACTS[lp.act]
            d.off_w[l] = off
            d.off_b[l] = off + lp.din * lp.dout
            off += lp.din * lp.dout + lp.dout
            d.off_h[l] = off_h
            off_h += lp.dout
            maxw = max(maxw, lp.dout)
        d.n_params, d.h_per_row, d.maxw = off, off_h, maxw
        return d

    def smem_params(self) -> int:
        """Floats of the kernel's shared parameter copy: each weight matrix
        with an odd row stride (``fu_layout``), then its bias."""
        return sum(lp.din * (lp.dout | 1) + lp.dout for lp in self.layers)

    def smem_bytes(self) -> int:
        """Shared memory of one K3/K7 block (``fu_smem_bytes``): the padded
        params; for 2·TILE forward rows (s and s') the inputs, every
        layer's outputs and Q; the tile's target-net Q(s') rows and its
        four per-row scalars; the TD terms and the value head's dz
        (3·TILE); four dz buffers of TILE rows (two per head). At least
        one float per thread (phase B's block max)."""
        d = self.desc()
        floats = (self.smem_params()
                  + 2 * TILE * (d.in_dim + d.h_per_row + d.num_actions)
                  + TILE * d.num_actions + 4 * TILE
                  + 3 * TILE + 4 * TILE * d.maxw)
        return 4 * max(floats, THREADS)


def _act_name(fn) -> Optional[str]:
    if fn is None:
        return "id"
    if fn is torch.tanh:
        return "tanh"
    if fn is torch.relu or fn is F.relu:
        return "relu"
    return None


def dense_plans(indexed_layers, prefix: str
                ) -> Optional[Tuple[LayerPlan, ...]]:
    """``(index, layer)`` pairs of Dense layers (tanh/relu/identity with
    bias) -> layer plans keyed ``{prefix}layers.{index}``, else None."""
    plans = []
    for i, l in indexed_layers:
        if not isinstance(l, Dense):
            return None
        act = _act_name(l.activation)
        if act is None or not l.use_bias:
            return None
        plans.append(LayerPlan(l.in_dim, l.out_dim, act,
                               f"{prefix}layers.{i}.w",
                               f"{prefix}layers.{i}.b"))
    return tuple(plans)


def _chain_layers(chain: Chain, prefix: str) -> Optional[Tuple[LayerPlan, ...]]:
    """All-Dense (after leading Flattens) chain -> layer plans, else None."""
    layers = list(enumerate(chain.layers))
    while layers and isinstance(layers[0][1], Flatten):
        layers = layers[1:]
    return dense_plans(layers, prefix) if layers else None


def plan_for(network) -> Optional[FusedPlan]:
    """A kernel plan if the network is a supported (dueling) Dense stack,
    else None."""
    if isinstance(network, DuelingNetwork):
        if any(not isinstance(l, Flatten) for l in network.base.layers):
            return None
        val = _chain_layers(network.val, "val.")
        adv = _chain_layers(network.adv, "adv.")
        if not val or not adv or val[0].din != adv[0].din:
            return None
        if val[-1].dout != 1:
            return None
        plan = FusedPlan(True, adv[0].din, adv[-1].dout, val, adv)
    elif isinstance(network, Chain):
        adv = _chain_layers(network, "")
        if not adv:
            return None
        plan = FusedPlan(False, adv[0].din, adv[-1].dout, (), adv)
    else:
        return None
    if (len(plan.layers) > MAX_LAYERS or plan.num_actions > MAX_ACTIONS
            or any(max(lp.din, lp.dout) > MAX_WIDTH for lp in plan.layers)
            or plan.smem_bytes() > MAX_SMEM):
        return None
    return plan


# ------------------------------------------------------------ plain version

def _apply_act(z, act: str):
    if act == "tanh":
        return torch.tanh(z)
    if act == "relu":
        return torch.relu(z)
    return z


def _act_grad(h, act: str):
    """d act / d z expressed through the post-activation value h."""
    if act == "tanh":
        return 1.0 - h * h
    if act == "relu":
        return (h > 0.0).float()
    return torch.ones_like(h)


def _fwd(plan: FusedPlan, params, x, layers):
    """Forward through a Dense stack; post-activation values, input first."""
    hs = [x]
    for lp in layers:
        hs.append(_apply_act(hs[-1] @ params[lp.w_name] + params[lp.b_name],
                             lp.act))
    return hs


def q_values(plan: FusedPlan, params, x):
    """``(q [N, A], adv activations, val activations or None)``: dueling
    ``V + A - Σ A / A`` or the chain's output."""
    adv_hs = _fwd(plan, params, x, plan.adv)
    if not plan.dueling:
        return adv_hs[-1], adv_hs, None
    val_hs = _fwd(plan, params, x, plan.val)
    a = adv_hs[-1]
    q = val_hs[-1][:, :1] + a - a.sum(dim=1, keepdim=True) * (
        1.0 / plan.num_actions)
    return q, adv_hs, val_hs


def _by_tile(x, tile: int):
    """``x [N, ...]`` zero-padded to whole tiles and viewed ``[nt, tile,
    ...]``."""
    nt = -(-x.shape[0] // tile)
    pad = x.new_zeros((nt * tile - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad]).view((nt, tile) + tuple(x.shape[1:]))


def _tile_order_sum(parts):
    """``parts [nt, ...]`` summed over dim 0 one tile after another, the
    order of the kernels' reduce."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def _fwd_bwd(plan: FusedPlan, params, obs_s, obs_sp, action, reward, done,
             weights, q_sp_tgt, gamma, double_q, alpha, eps, tile=None):
    """One sub-update's forward, TD loss and hand-derived backward.
    Returns ``(grads {name: tensor}, td, prio, loss)``. With ``tile``, each
    gradient is per tile of ``tile`` rows (``[nt, *shape]``, the kernels'
    partials) and the loss sums the per-tile Huber sums in tile order."""
    B, A = obs_s.shape[0], plan.num_actions
    q_s, adv_hs, val_hs = q_values(plan, params, obs_s)
    if double_q:
        best = torch.argmax(q_values(plan, params, obs_sp)[0], dim=1)
        q_sp_max = torch.gather(q_sp_tgt, 1, best[:, None])[:, 0]
    else:
        q_sp_max = q_sp_tgt.max(dim=1).values
    target = reward + (1.0 - done) * gamma * q_sp_max
    q_sa = select_action(q_s, action)
    td = q_sa - target
    xw = weights * td
    absx = xw.abs()
    quad = absx.clamp(max=1.0)
    huber = 0.5 * quad * quad + (absx - quad)
    if tile is None:
        loss = huber.sum() * (1.0 / B)
    else:
        loss = _tile_order_sum(_by_tile(huber, tile).sum(dim=1)) * (1.0 / B)
    prio = (td.abs() + eps) ** alpha

    g_sa = weights * xw.clamp(-1.0, 1.0) * (1.0 / B)
    g_q = torch.where(action_mask(q_s, action), g_sa[:, None], 0.0)
    grads: Dict[str, torch.Tensor] = {}

    def bwd(layers, hs, dh):
        for i in reversed(range(len(layers))):
            lp = layers[i]
            dz = dh * _act_grad(hs[i + 1], lp.act)
            if tile is None:
                grads[lp.w_name] = hs[i].t() @ dz
                grads[lp.b_name] = dz.sum(dim=0)
            else:
                ht, zt = _by_tile(hs[i], tile), _by_tile(dz, tile)
                grads[lp.w_name] = ht.transpose(1, 2) @ zt
                grads[lp.b_name] = zt.sum(dim=1)
            if i > 0:
                dh = dz @ params[lp.w_name].t()

    if plan.dueling:
        # through q = v + a - mean(a): g_adv = g_q - sum(g_q)/A, g_val = sum
        sum_g = g_q.sum(dim=1, keepdim=True)
        bwd(plan.val, val_hs, sum_g)
        bwd(plan.adv, adv_hs, g_q - sum_g * (1.0 / A))
    else:
        bwd(plan.adv, adv_hs, g_q)
    return grads, td, prio, loss


def adam_plain(names, params, m, v, grads, t, lr, b1, b2, adam_eps):
    """Adam with bias correction at step ``t`` (an int, or a 0-d int tensor
    on the parameters' device: the corrections are then computed there in
    f64, as the host computes them for an int), in place on ``params``,
    ``m`` and ``v`` for each key of ``names``."""
    if torch.is_tensor(t):
        t = t.to(torch.float64)
    c1 = 1.0 / (1.0 - b1 ** t)
    c2 = 1.0 / (1.0 - b2 ** t)
    for name in names:
        g = grads[name]
        m[name].mul_(b1).add_((1.0 - b1) * g)
        v[name].mul_(b2).add_((1.0 - b2) * (g * g))
        params[name].sub_(lr * (m[name] * c1)
                          / (torch.sqrt(v[name] * c2) + adam_eps))


def fused_group_update_plain(plan: FusedPlan, params, m, v, count, obs, nobs,
                             action, reward, done, weights, q_sp_tgt, *,
                             gamma, double_q, lr, alpha, eps, batch_size,
                             n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Plain PyTorch version; same contract as :func:`fused_group_update`."""
    B, U = batch_size, n_updates
    tds, prios = [], []
    loss = gnorm = None
    t0 = count.to(torch.int64)
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        grads, td, prio, loss = _fwd_bwd(
            plan, params, obs[sl], nobs[sl] if double_q else None,
            action[sl].long(), reward[sl], done[sl], weights[sl],
            q_sp_tgt[sl], gamma, double_q, alpha, eps)
        tds.append(td)
        prios.append(prio)
        gnorm = torch.stack([g.abs().max() for g in grads.values()]).max()
        adam_plain(plan.names, params, m, v, grads, t0 + (u + 1), lr, b1, b2,
                   adam_eps)
    count.add_(U)
    return torch.stack(tds), torch.stack(prios), loss, gnorm


def fused_group_update_tiled(plan: FusedPlan, params, m, v, count, obs,
                             nobs, action, reward, done, weights, q_sp_tgt,
                             *, gamma, double_q, lr, alpha, eps, batch_size,
                             n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Plain reference in the kernel's sum order; same contract as
    :func:`fused_group_update`. Per sub-update: each tile of ``TILE`` rows'
    partial gradient, the partials summed in tile order (``gnorm`` the
    max-abs entry of that sum), the Huber loss likewise, then Adam."""
    B, U = batch_size, n_updates
    tds, prios = [], []
    loss = gnorm = None
    t0 = count.to(torch.int64)
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        parts, td, prio, loss = _fwd_bwd(
            plan, params, obs[sl], nobs[sl] if double_q else None,
            action[sl].long(), reward[sl], done[sl], weights[sl],
            q_sp_tgt[sl], gamma, double_q, alpha, eps, tile=TILE)
        nt = parts[plan.names[0]].shape[0]
        flat = _tile_order_sum(torch.cat(
            [parts[n].reshape(nt, -1) for n in plan.names], dim=1))
        tds.append(td)
        prios.append(prio)
        gnorm = flat.abs().max()
        adam_plain(plan.names, params, m, v, unflatten(flat, params,
                                                       plan.names),
                   t0 + (u + 1), lr, b1, b2, adam_eps)
    count.add_(U)
    return torch.stack(tds), torch.stack(prios), loss, gnorm


def partials(plan: FusedPlan, B: int, device):
    """K3's and K7's scratch: one partial gradient and one Huber sum per
    tile of ``TILE`` rows, ``([ceil(B/TILE), n_params], [ceil(B/TILE)])``,
    indexed by tile whatever the grid."""
    nt = -(-B // TILE)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(nt, plan.desc().n_params, **f32),
            torch.empty(nt, **f32))


_MAX_GRID: Dict[Tuple[FusedPlan, int], int] = {}


def launch_grid(plan: FusedPlan, B: int, device) -> int:
    """Blocks of one K3/K7 cooperative launch: the card's co-resident block
    count for this plan (asked once per plan and device), capped at the
    work: the tiles of phase A or one thread per parameter in phase B,
    whichever needs more blocks."""
    dev = torch.device(device)
    key = (plan, torch.cuda.current_device() if dev.index is None
           else dev.index)
    if key not in _MAX_GRID:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            build.check(build.library().dq_fused_update_max_grid(
                plan.desc(), ctypes.byref(out)), "fused_update (grid)")
        _MAX_GRID[key] = out.value
    need = max(-(-B // TILE), -(-plan.desc().n_params // THREADS))
    return min(_MAX_GRID[key], need)


def fused_group_update_cuda(plan: FusedPlan, params, m, v, count, obs, nobs,
                            action, reward, done, weights, q_sp_tgt, *,
                            gamma, double_q, lr, alpha, eps, batch_size,
                            n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """Launch K3 (one cooperative kernel on the current stream)."""
    B, U = batch_size, n_updates
    obs = obs.float().contiguous()
    nobs = nobs.float().contiguous()
    action = action.to(torch.int32).contiguous()
    reward, done, weights, q_sp_tgt = (
        t.float().contiguous() for t in (reward, done, weights, q_sp_tgt))
    tensors = [params[n] for n in plan.names]
    mt, vt = [m[n] for n in plan.names], [v[n] for n in plan.names]
    build.require_cuda(obs, nobs, action, reward, done, weights, q_sp_tgt,
                       count, *tensors, *mt, *vt)
    if count.dtype != torch.int32:
        raise ValueError("the Adam count must be an int32 tensor")
    for ts in (tensors, mt, vt):
        build.require_plan_params(plan, ts)
    for name, t in (("obs", obs), ("nobs", nobs)):
        build.require_shape(t, (U * B, plan.in_dim), name)
    build.require_shape(q_sp_tgt, (U * B, plan.num_actions), "q_sp_tgt")
    dev = obs.device
    d = plan.desc()
    td = torch.empty(U * B, dtype=torch.float32, device=dev)
    prio = torch.empty_like(td)
    part_grad, part_loss = partials(plan, B, dev)
    stage = torch.empty(plan.smem_params(), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    ptrs = lambda ts: build.int64_array([t.data_ptr() for t in ts])
    err = build.library().dq_fused_update(
        d, ptrs(tensors), ptrs(mt), ptrs(vt), count.data_ptr(), U, B,
        obs.data_ptr(), nobs.data_ptr(), action.data_ptr(),
        reward.data_ptr(), done.data_ptr(), weights.data_ptr(),
        q_sp_tgt.data_ptr(), gamma, alpha, eps, int(bool(double_q)), lr, b1,
        b2, adam_eps, td.data_ptr(), prio.data_ptr(), part_grad.data_ptr(),
        part_loss.data_ptr(), loss.data_ptr(), gnorm.data_ptr(),
        stage.data_ptr(), launch_grid(plan, B, dev), build.stream_ptr(dev))
    build.check(err, "fused_group_update")
    fused_group_update_cuda.launches += 1
    count.add_(U)
    return td.view(U, B), prio.view(U, B), loss, gnorm


fused_group_update_cuda.launches = 0


def fused_group_update(plan: FusedPlan, params, m, v, count, obs, nobs,
                       action, reward, done, weights, q_sp_tgt, *, gamma,
                       double_q, lr, alpha, eps, batch_size, n_updates,
                       b1=0.9, b2=0.999, adam_eps=1e-8):
    """Run U fused sub-updates IN PLACE on ``params``/``m``/``v`` (dicts of
    tensors keyed as ``plan.names``) and ``count`` (int32 scalar tensor).

    ``obs``/``nobs`` ``[U·B, in_dim]`` (``nobs`` unused without double-Q),
    ``action``/``reward``/``done``/``weights`` ``[U·B]``, ``q_sp_tgt``
    ``[U·B, A]``, all u-major. Returns ``(tds [U, B], prios [U, B], loss,
    gnorm)`` with the last sub-update's loss and max-abs gradient."""
    n = batch_size * n_updates
    for name, t in (("obs", obs), ("action", action), ("reward", reward),
                    ("done", done), ("weights", weights),
                    ("q_sp_tgt", q_sp_tgt)) + ((("nobs", nobs),)
                                               if double_q else ()):
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected "
                             f"batch_size*n_updates = {n}")
    fn = fused_group_update_cuda if obs.is_cuda else fused_group_update_plain
    flat = lambda x: x.reshape(x.shape[0], -1)
    return fn(plan, params, m, v, count, flat(obs), flat(nobs), action,
              reward, done, weights, q_sp_tgt, gamma=gamma, double_q=double_q, lr=lr,
              alpha=alpha, eps=eps, batch_size=batch_size,
              n_updates=n_updates, b1=b1, b2=b2, adam_eps=adam_eps)


# -------------------------------------- K7: one sub-update, emitting grads

def fused_grads_plain(plan: FusedPlan, params, obs_s, obs_sp, action, reward,
                      done, weights, q_sp_tgt, *, gamma, double_q, alpha,
                      eps):
    """Plain PyTorch version of :func:`fused_grads`, returning the flat
    gradient ``[n_params]`` in place of the dict."""
    grads, td, prio, loss = _fwd_bwd(
        plan, params, obs_s, obs_sp if double_q else None, action.long(),
        reward, done, weights, q_sp_tgt, gamma, double_q, alpha, eps)
    flat = flatten(grads, plan.names)
    return flat, td, prio, loss, flat.abs().max()


def _k7_inputs(plan: FusedPlan, params, n, obs, nobs, action, reward, done,
               weights, q_sp_tgt, double_q):
    """K7's inputs of ``n`` rows as contiguous f32 (int32 actions) CUDA
    tensors, checked against the plan; and the parameter tensors in plan
    order."""
    obs = obs.float().contiguous()
    nobs = nobs.float().contiguous() if double_q else obs
    action = action.to(torch.int32).contiguous()
    reward, done, weights, q_sp_tgt = (
        t.float().contiguous() for t in (reward, done, weights, q_sp_tgt))
    tensors = [params[k] for k in plan.names]
    build.require_cuda(obs, nobs, action, reward, done, weights, q_sp_tgt,
                       *tensors)
    build.require_plan_params(plan, tensors)
    for name, t in (("obs", obs), ("nobs", nobs)):
        build.require_shape(t, (n, plan.in_dim), name)
    for name, t in (("action", action), ("reward", reward), ("done", done),
                    ("weights", weights)):
        build.require_shape(t, (n,), name)
    build.require_shape(q_sp_tgt, (n, plan.num_actions), "q_sp_tgt")
    return (obs, nobs, action, reward, done, weights, q_sp_tgt), tensors


def fused_grads_cuda(plan: FusedPlan, params, obs_s, obs_sp, action, reward,
                     done, weights, q_sp_tgt, *, gamma, double_q, alpha,
                     eps):
    """Launch K7 (one cooperative kernel on the current stream); returns
    what :func:`fused_grads_plain` returns."""
    B = action.shape[0]
    xs, tensors = _k7_inputs(plan, params, B, obs_s, obs_sp, action, reward,
                             done, weights, q_sp_tgt, double_q)
    d = plan.desc()
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    td, prio = torch.empty(B, **f32), torch.empty(B, **f32)
    part_grad, part_loss = partials(plan, B, dev)
    flat = torch.empty(d.n_params, **f32)
    loss, gnorm = torch.empty((), **f32), torch.empty((), **f32)
    err = build.library().dq_fused_grads(
        d, build.int64_array([t.data_ptr() for t in tensors]), B,
        *(x.data_ptr() for x in xs), gamma, alpha, eps, int(bool(double_q)),
        td.data_ptr(), prio.data_ptr(), part_grad.data_ptr(),
        part_loss.data_ptr(), flat.data_ptr(), loss.data_ptr(),
        gnorm.data_ptr(), launch_grid(plan, B, dev), build.stream_ptr(dev))
    build.check(err, "fused_grads")
    fused_grads_cuda.launches += 1
    return flat, td, prio, loss, gnorm


fused_grads_cuda.launches = 0


def fused_grads(plan: FusedPlan, params, obs_s, obs_sp, action, reward, done,
                weights, q_sp_tgt, *, gamma, double_q, alpha, eps):
    """One sub-update's forward, TD loss and backward on ``B`` rows, params
    read only: ``obs_s``/``obs_sp [B, in_dim]`` (``obs_sp`` unused without
    double-Q), ``action``/``reward``/``done``/``weights [B]``, ``q_sp_tgt
    [B, A]``. Returns ``(grads, td [B], prio [B], loss, gnorm)``, the
    contract of the JAX ``fused_grads``: ``grads`` are views, shaped like
    ``params``, of one flat f32 gradient in ``plan.names`` order (which
    ``fused_grads_cuda``/``_plain`` return), and ``gnorm`` is the local
    max-abs."""
    B = action.shape[0]
    for name, t in (("obs_s", obs_s), ("obs_sp", obs_sp), ("reward", reward),
                    ("done", done), ("weights", weights)):
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {B}")
    if tuple(q_sp_tgt.shape) != (B, plan.num_actions):
        raise ValueError(f"q_sp_tgt has shape {tuple(q_sp_tgt.shape)}, "
                         f"expected {(B, plan.num_actions)}")
    fn = fused_grads_cuda if obs_s.is_cuda else fused_grads_plain
    flat2 = lambda x: x.reshape(x.shape[0], -1)
    flat, td, prio, loss, gnorm = fn(
        plan, params, flat2(obs_s), flat2(obs_sp), action, reward, done,
        weights, q_sp_tgt, gamma=gamma, double_q=double_q, alpha=alpha,
        eps=eps)
    return unflatten(flat, params, plan.names), td, prio, loss, gnorm


# ------------------- the data-parallel grouped update: K7, reduce, Adam

def adam_flat_plain(names, params, m, v, count, flat, *, u, lr, b1=0.9,
                    b2=0.999, adam_eps=1e-8):
    """Plain Adam step ``t = count + u + 1`` from a flat gradient in
    ``names`` order, in place; returns the gradient's max-abs entry.
    ``count`` is not advanced."""
    adam_plain(names, params, m, v, unflatten(flat, params, names),
               count.to(torch.int64) + (u + 1), lr, b1, b2, adam_eps)
    return flat.abs().max()


def fused_dp_group_update_plain(plan: FusedPlan, params, m, v, count, obs,
                                nobs, action, reward, done, weights, q_sp_tgt,
                                *, reduce, gamma, double_q, lr, alpha, eps,
                                batch_size, n_updates, b1=0.9, b2=0.999,
                                adam_eps=1e-8):
    """Plain PyTorch version; same contract as
    :func:`fused_dp_group_update`."""
    B, U = batch_size, n_updates
    tds, prios = [], []
    for u in range(U):
        sl = slice(u * B, (u + 1) * B)
        flat, td, prio, loss, _ = fused_grads_plain(
            plan, params, obs[sl], nobs[sl], action[sl], reward[sl],
            done[sl], weights[sl], q_sp_tgt[sl], gamma=gamma,
            double_q=double_q, alpha=alpha, eps=eps)
        reduce(flat)
        gnorm = adam_flat_plain(plan.names, params, m, v, count, flat, u=u,
                                lr=lr, b1=b1, b2=b2, adam_eps=adam_eps)
        tds.append(td)
        prios.append(prio)
    count.add_(U)
    return torch.stack(tds), torch.stack(prios), loss, gnorm


def fused_dp_group_update_cuda(plan: FusedPlan, params, m, v, count, obs,
                               nobs, action, reward, done, weights, q_sp_tgt,
                               *, reduce, gamma, double_q, lr, alpha, eps,
                               batch_size, n_updates, b1=0.9, b2=0.999,
                               adam_eps=1e-8):
    """Per sub-update on the current stream: K7 (one cooperative launch),
    ``reduce`` of its flat gradient, and the Adam launch on that vector.
    The inputs, parameters and moments are checked, and the outputs and
    scratch allocated, once for all U sub-updates."""
    B, U = batch_size, n_updates
    xs, tensors = _k7_inputs(plan, params, U * B, obs, nobs, action, reward,
                             done, weights, q_sp_tgt, double_q)
    mt, vt = [m[k] for k in plan.names], [v[k] for k in plan.names]
    build.require_cuda(count, *mt, *vt)
    if count.dtype != torch.int32:
        raise ValueError("the Adam count must be an int32 tensor")
    for ts in (mt, vt):
        build.require_plan_params(plan, ts)
    d = plan.desc()
    dev = xs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    td, prio = torch.empty(U * B, **f32), torch.empty(U * B, **f32)
    part_grad, part_loss = partials(plan, B, dev)
    flat = torch.empty(U, d.n_params, **f32)
    loss, lgn, gnorm = (torch.empty(U, **f32) for _ in range(3))
    ptrs = lambda ts: build.int64_array([t.data_ptr() for t in ts])
    P, M, V = ptrs(tensors), ptrs(mt), ptrs(vt)
    lib, stream = build.library(), build.stream_ptr(dev)
    # sub-batch u starts u·B rows into each input and output; every element
    # is 4 bytes
    rows = [(x.data_ptr(), 4 * B * x[0].numel()) for x in (*xs, td, prio)]
    scratch = part_grad.data_ptr(), part_loss.data_ptr()
    per_u = [(t.data_ptr(), 4 * k) for t, k in ((flat, d.n_params),
                                                 (loss, 1), (lgn, 1))]
    dq, cnt, g_out = int(bool(double_q)), count.data_ptr(), gnorm.data_ptr()
    grid = launch_grid(plan, B, dev)
    for u in range(U):
        p = [base + u * step for base, step in rows]
        err = lib.dq_fused_grads(d, P, B, *p[:7], gamma, alpha, eps, dq,
                                 *p[7:], *scratch,
                                 *(base + u * step for base, step in per_u),
                                 grid, stream)
        build.check(err, "fused_grads")
        fused_grads_cuda.launches += 1
        reduce(flat[u])
        err = lib.dq_fused_adam(d, P, M, V, cnt, u, per_u[0][0] +
                                u * per_u[0][1], lr, b1, b2, adam_eps,
                                g_out + 4 * u, stream)
        build.check(err, "fused_dp_group_update (Adam)")
    fused_dp_group_update_cuda.launches += 1
    count.add_(U)
    return td.view(U, B), prio.view(U, B), loss[U - 1], gnorm[U - 1]


fused_dp_group_update_cuda.launches = 0


def fused_dp_group_update(plan: FusedPlan, params, m, v, count, obs, nobs,
                          action, reward, done, weights, q_sp_tgt, *, reduce,
                          gamma, double_q, lr, alpha, eps, batch_size,
                          n_updates, b1=0.9, b2=0.999, adam_eps=1e-8):
    """U data-parallel sub-updates IN PLACE on ``params``/``m``/``v`` and
    ``count``, with the inputs of :func:`fused_group_update`. Per
    sub-update u: K7 on rows ``[u·B, (u+1)·B)``, ``reduce(flat)`` on its
    flat gradient (in place: the all-reduce that averages it over the
    ranks), then Adam at ``t = count + u + 1`` from that vector. Returns
    ``(tds [U, B], prios [U, B], loss, gnorm)``: the last sub-update's
    local loss and the max-abs of its reduced gradient."""
    n = batch_size * n_updates
    for name, t in (("obs", obs), ("action", action), ("reward", reward),
                    ("done", done), ("weights", weights),
                    ("q_sp_tgt", q_sp_tgt)) + ((("nobs", nobs),)
                                               if double_q else ()):
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected "
                             f"batch_size*n_updates = {n}")
    fn = fused_dp_group_update_cuda if obs.is_cuda else \
        fused_dp_group_update_plain
    flat2 = lambda x: x.reshape(x.shape[0], -1)
    return fn(plan, params, m, v, count, flat2(obs), flat2(nobs), action,
              reward, done, weights, q_sp_tgt, reduce=reduce, gamma=gamma,
              double_q=double_q, lr=lr, alpha=alpha, eps=eps,
              batch_size=batch_size, n_updates=n_updates, b1=b1, b2=b2,
              adam_eps=adam_eps)
