"""K4 and K6: one collect step for all E envs (``csrc/fused_collect.cu``).

Replaces ``fused_collect`` (body ``_collect_block``) of
``deepqlearning_tpu/ops/pallas/fused_collect.py``, K4 its feed-forward plan
and K6 its recurrent plan: (K6 only: one LSTM or GRU cell step on the obs
and the env's state row, the state zeroed where the episode ended) the
(dueling) Dense forward, ε-greedy with the first-max argmax and a random action
``floor(u1·A)`` when ``u0 < ε``, the env's ``step_cols`` and
``reset_cols``, truncation at ``max_episode_length``, auto-reset and the
episode accumulators. Transition fields come out in replay-row order
``[E, 2·no + 4]`` = (obs, obs', action, reward, done, ended); the per-tile
(Σ ret·ended, Σ len·ended, Σ ended) partials are summed by plain torch.

ε comes in as a 0-d f32 tensor on the device (the actor's schedule of its
device step count), which the kernels read through a pointer, as the JAX
kernel takes ε as an array: a captured launch then follows the counter.
Uniforms come in as ``u [2 + ns + nr, E]`` (``CollectPlan.n_uniforms``) —
rows: explore, random action, the env's ``ns`` step uniforms, its ``nr``
reset uniforms — the layout of the JAX kernel's host uniforms: 6 rows for
SimpleGridWorld and CartPole, 3 for MountainCar. The kernels serve the
port's envs that speak the JAX cols protocol — SimpleGridWorld, CartPole and
MountainCar — each by its own device code (a template parameter), with its
constants read from the env object (:func:`env_desc`). On the card, both
run a tile of ``CollectPlan.tile`` envs per block, each Dense layer a small
matrix product in shared memory (register micro-tiles of 4 envs x 4
outputs), then the env step a thread per env; K6 first steps the cell on the
tile, 4 envs x one hidden unit (all its gates) per work item. The forward's
FLOPs bound both (see the source). :func:`fused_collect_rnn_tiled` is K6's
arithmetic in its order, a plain reference.

:func:`collect_plan_for` is the gate. It takes the envs above within the
JAX gate's limits (obs <= 64, state width <= 32, 2 + ns + nr <= 32). The
recurrent plan takes a leading LSTM/GRU cell followed by a Dense stack, or
a dueling net whose base is exactly that cell; unlike the JAX plan it also
budgets the cell and the head together against this card's shared memory.
K4's env tile is the largest of ``K4_TILES`` whose shared memory
(:func:`k4_smem_bytes`) fits the card's per-block limit, K6's the largest of
``K6_TILES`` (:func:`k6_smem_bytes`); every net within the gate has one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...envs.cartpole import CartPole
from ...envs.gridworld import SimpleGridWorld
from ...envs.mountain_car import MountainCar
from ...models.chain import Chain, Flatten
from ...models.dueling import DuelingNetwork
from . import build
from .fused_drqn import CellPlan, cell_plan, cell_step
from .fused_update import (
    MAX_LAYERS, FusedPlan, MAX_SMEM, _apply_act, _by_tile, _chain_layers,
    _tile_order_sum, dense_plans, plan_for, q_values)

MAX_WIDTH = 128   # FC_MAXW of csrc/fused_collect.cu
THREADS = 256     # FC_THREADS
# The envs with device code in the kernels, by exact type (a subclass may
# override step_cols/reset_cols, which the device code would not follow):
# FcEnv<kind> of the source, and EnvDesc.k, the constants in the order the
# source reads them.
ENVS = {
    SimpleGridWorld: (0, lambda e: (e.tprob, e.size[0], e.size[1])),
    CartPole: (1, lambda e: (
        e.gravity, e.masspole, e.masscart + e.masspole, e.length,
        e.masspole * e.length, e.force_mag, e.tau, e.theta_threshold,
        e.x_threshold, 4.0 / 3.0)),
    MountainCar: (2, lambda e: (
        e.min_position, e.max_position, e.max_speed, e.goal_position,
        e.force, e.gravity)),
}
K4_TILES = (128, 64, 32, 16, 8, 4)   # env tiles, FC_MAX_TE first
# K6's env tiles: at most 32, so the DRQN loop's 16384 envs make 512 blocks,
# several per SM (LSTM32 on an H100 at 700 W, by kernel_events' device
# events: 0.0206 ms at 32 against 0.0224 at 64 and 0.0294 at 128)
K6_TILES = (32, 16, 8, 4)
# shared memory a block may use on sm_90 (232448 bytes, opt-in), less 1 KB
# for fc_kernel's static shared memory
K4_MAX_SMEM = 232448 - 1024


@dataclasses.dataclass(frozen=True)
class CollectPlan:
    net: FusedPlan             # the Dense head (input: obs, or h')
    cell: Optional[CellPlan]   # the leading recurrent cell (K6), or None
    no: int   # flat obs dim
    W: int    # env state width
    ns: int   # the env's step uniforms
    nr: int   # the env's reset uniforms
    nf: int   # replay field columns: 2*no + 4 (a, r, done, ended)
    tile: int  # envs per block of K4 or K6

    @property
    def n_uniforms(self) -> int:
        """Rows of ``u``: explore, random action, step, reset."""
        return 2 + self.ns + self.nr

    @property
    def state_width(self) -> int:
        """Columns of the cell's state rows ``[E, S]``: h;c or h."""
        return (2 if self.cell.kind == "lstm" else 1) * self.cell.hidden


def k4_smem_params(net: FusedPlan) -> int:
    """Floats of K4's shared parameter copy (``fc_tile_layout``): each
    layer's W then b, every tensor on a 16-byte boundary."""
    n = 0
    for lp in net.layers:
        n = -(-(n + lp.din * lp.dout) // 4) * 4
        n = -(-(n + lp.dout) // 4) * 4
    return n


def k4_smem_bytes(net: FusedPlan, tile: int) -> int:
    """Shared memory of one K4 block (``fc_tile_smem_bytes``): the params,
    the tile's inputs and two activation buffers feature-major, the value
    head's output, and the block's accumulator sums."""
    d = net.desc()
    return 4 * (k4_smem_params(net) + (d.in_dim + 2 * d.maxw + 1) * tile
                + 3 * THREADS)


def k4_tile(net: FusedPlan) -> Optional[int]:
    """K4's env tile for this head: the largest of ``K4_TILES`` that fits."""
    for te in K4_TILES:
        if k4_smem_bytes(net, te) <= K4_MAX_SMEM:
            return te
    return None


def k6_smem_bytes(net: FusedPlan, cell: CellPlan, tile: int) -> int:
    """Shared memory of one K6 block (``fc_rnn_layout``): the head's params
    as K4 packs them, the cell's ``[wi; wh]`` and bias (each padded to 4
    floats), the tile's obs and h rows, c rows (LSTM) and h' rows at a
    stride of ``tile + 4``, the head's two buffers, the value output, the
    end flags and the block's accumulator sums."""
    H, g = cell.hidden, cell.n_gates * cell.hidden
    rows = cell.in_dim + H + (H if cell.kind == "lstm" else 0) + H
    pad = lambda n: -(-n // 4) * 4
    return 4 * (k4_smem_params(net) + pad((cell.in_dim + H) * g) + pad(g)
                + rows * (tile + 4) + 2 * net.desc().maxw * tile + 2 * tile
                + 3 * THREADS)


def k6_tile(net: FusedPlan, cell: CellPlan) -> Optional[int]:
    """K6's env tile: the largest of ``K6_TILES`` that fits."""
    for te in K6_TILES:
        if k6_smem_bytes(net, cell, te) <= K4_MAX_SMEM:
            return te
    return None


def _recurrent_plan(network):
    """(head plan, cell plan) for ``[Flatten]* LSTM|GRU [Dense]+`` or a
    dueling net whose base is ``[Flatten]* LSTM|GRU``, else None."""
    if isinstance(network, DuelingNetwork):
        layers = [(i, l) for i, l in enumerate(network.base.layers)
                  if not isinstance(l, Flatten)]
        if len(layers) != 1:
            return None
        ci, cell = layers[0]
        cp = cell_plan(cell, f"base.layers.{ci}.", ci)
        val = _chain_layers(network.val, "val.")
        adv = _chain_layers(network.adv, "adv.")
        if cp is None or not val or not adv or val[-1].dout != 1:
            return None
        head = FusedPlan(True, cp.hidden, adv[-1].dout, val, adv)
    elif isinstance(network, Chain):
        layers = [(i, l) for i, l in enumerate(network.layers)]
        while layers and isinstance(layers[0][1], Flatten):
            layers = layers[1:]
        if not layers:
            return None
        ci, cell = layers[0]
        cp = cell_plan(cell, f"layers.{ci}.", ci)
        adv = dense_plans(layers[1:], "")
        if cp is None or not adv:
            return None
        head = FusedPlan(False, cp.hidden, adv[-1].dout, (), adv)
    else:
        return None
    if head.val and head.val[0].din != cp.hidden or \
            head.adv[0].din != cp.hidden:
        return None
    return head, cp


def env_kind(env) -> Optional[int]:
    """The kernels' device code for ``env`` (``FcEnv<kind>``), or None."""
    spec = ENVS.get(type(env))
    return None if spec is None else spec[0]


def env_desc(env) -> build.EnvDesc:
    """``struct EnvDesc`` for the kernels: the env's kind and constants,
    read from the object (``ENVS``)."""
    d = build.EnvDesc()
    d.kind, consts = ENVS[type(env)]
    if d.kind == 0:
        d.n_cells = len(env.reward_cells)
        for i, (x, y, r) in enumerate(env.reward_cells):
            d.cell_x[i], d.cell_y[i], d.cell_r[i] = x, y, r
    for i, v in enumerate(consts(env)):
        d.k[i] = v
    return d


def collect_plan_for(env, network, buffer) -> Optional[CollectPlan]:
    """Static gate: an env the kernels step (SimpleGridWorld, CartPole,
    MountainCar; of exactly that type) within the JAX gate's limits, a kernel-supported network on
    the flat obs — a (dueling) Dense stack (K4), or a leading LSTM/GRU cell
    before one (K6) — within the kernel's widths and shared memory, and f32
    replay storage. None means the plain keyed collect step."""
    if env_kind(env) is None:
        return None
    if len(getattr(env, "reward_cells", ())) > build.FC_MAXCELLS:
        return None
    cell = None
    if getattr(network, "recurrent", False):
        rp = _recurrent_plan(network)
        if rp is None:
            return None
        net, cell = rp
    else:
        net = plan_for(network)
        if net is None:
            return None
    no = 1
    for s in env.obs_shape:
        no *= int(s)
    W, ns, nr = (int(env.lane_state_width), int(env.n_uniform_step),
                 int(env.n_uniform_reset))
    if no > 64 or W > 32 or 2 + ns + nr > 32:
        return None
    if (cell.in_dim if cell is not None else net.in_dim) != no:
        return None
    if any(lp.dout > MAX_WIDTH for lp in net.layers):
        return None
    if len(net.layers) > MAX_LAYERS:
        return None
    cell_floats = 0
    if cell is not None:
        g = cell.n_gates * cell.hidden
        cell_floats = g * (cell.in_dim + cell.hidden + 1)
    if 4 * (net.desc().n_params + cell_floats + 3 * THREADS) > MAX_SMEM:
        return None
    tile = k4_tile(net) if cell is None else k6_tile(net, cell)
    if tile is None:
        return None
    if buffer is not None and getattr(buffer, "obs_dtype", None) != \
            torch.float32:
        return None
    return CollectPlan(net=net, cell=cell, no=no, W=W, ns=ns, nr=nr,
                       nf=2 * no + 4, tile=tile)


def _collect_rest(env, plan: CollectPlan, q, nstate, *, obs, state,
                  ep_step, ep_ret, u, eps, max_episode_length: int,
                  tile=None):
    """Everything after Q(s): epsilon-greedy, the env step and its
    bookkeeping, and (``nstate`` given) the new state rows zeroed where the
    episode ended; with ``tile``, the totals summed per tile of envs and
    then in tile order."""
    A = plan.net.num_actions
    greedy = torch.argmax(q, dim=1).float()
    rand_a = torch.floor(u[1] * float(A))
    action = torch.where(u[0] < eps, rand_a, greedy)
    s0, s1 = 2 + plan.ns, 2 + plan.ns + plan.nr
    new_state, nobs, rew, done = env.step_cols(state, action, u[2:s0])
    ep1 = ep_step.float() + 1.0
    ended = torch.maximum(done, (ep1 >= float(max_episode_length)).float())
    ret1 = ep_ret + rew
    r_state, r_obs = env.reset_cols(u[s0:s1])
    end = ended[:, None] > 0.5
    fields = torch.cat([obs.reshape(obs.shape[0], -1), nobs, action[:, None],
                        rew[:, None], done[:, None], ended[:, None]], dim=1)
    terms = torch.stack([ret1 * ended, ep1 * ended, ended], dim=1)
    totals = (terms.sum(dim=0) if tile is None
              else _tile_order_sum(_by_tile(terms, tile).sum(dim=1)))
    out = (fields, torch.where(end, r_obs, nobs),
           torch.where(end, r_state, new_state),
           torch.where(ended > 0.5, 0.0, ep1).to(torch.int32),
           torch.where(ended > 0.5, 0.0, ret1), totals)
    if nstate is not None:
        out += (torch.where(end, 0.0, nstate),)
    return out


def fused_collect_plain(env, plan: CollectPlan, params, *, obs, state,
                        ep_step, ep_ret, u, eps,
                        max_episode_length: int, nstate=None):
    """Plain PyTorch version; same contract as :func:`fused_collect`."""
    x = obs.reshape(obs.shape[0], -1)
    if plan.cell is not None:
        H = plan.cell.hidden
        h, c = cell_step(plan.cell, params, x, nstate[:, :H],
                         nstate[:, H:] if plan.cell.kind == "lstm" else None)
        nstate = h if c is None else torch.cat([h, c], dim=1)
        x = h
    q, _, _ = q_values(plan.net, params, x)
    return _collect_rest(env, plan, q, nstate, obs=obs, state=state,
                         ep_step=ep_step, ep_ret=ep_ret, u=u, eps=eps,
                         max_episode_length=max_episode_length)


def _ordered_matmul(x, w):
    """``x [N, din] @ w [din, dout]``, each sum over ``din`` in ascending
    order (K6's order)."""
    acc = x.new_zeros(x.shape[0], w.shape[1])
    for i in range(w.shape[0]):
        acc = acc + x[:, i:i + 1] * w[i]
    return acc


def fused_collect_rnn_tiled(env, plan: CollectPlan, params, *, obs, state,
                            ep_step, ep_ret, u, eps,
                            max_episode_length: int, nstate):
    """Plain reference of K6 in its order: each gate sum over the rows x
    then h in ascending order (the GRU's n gate as x . W_in and h . W_hn
    apart), the cell, the head's sums likewise, the dueling mean summed
    over the actions in order, and the totals per tile of ``plan.tile``
    envs then in tile order. Same contract as the recurrent
    :func:`fused_collect`; the twin's matmuls round in other orders."""
    cp, hp = plan.cell, plan.net
    H, x = cp.hidden, obs.reshape(obs.shape[0], -1)
    wi, wh, b = (params[n] for n in cp.names)
    h = nstate[:, :H]
    xh, w = torch.cat([x, h], dim=1), torch.cat([wi, wh], dim=0)
    sig = torch.sigmoid
    if cp.kind == "lstm":
        a = _ordered_matmul(xh, w)
        i, f, g, o = (a[:, k * H:(k + 1) * H] + b[k * H:(k + 1) * H]
                      for k in range(4))
        c = sig(f) * nstate[:, H:] + sig(i) * torch.tanh(g)
        h = sig(o) * torch.tanh(c)
        new = torch.cat([h, c], dim=1)
    else:
        a = _ordered_matmul(xh, w[:, :2 * H])
        xn = _ordered_matmul(x, wi[:, 2 * H:])
        hn = _ordered_matmul(h, wh[:, 2 * H:])
        r = sig(a[:, :H] + b[:H])
        z = sig(a[:, H:] + b[H:2 * H])
        n = torch.tanh(xn + r * hn + b[2 * H:])
        h = (1.0 - z) * n + z * h
        new = h

    def chain(layers, y):
        for lp in layers:
            y = _apply_act(_ordered_matmul(y, params[lp.w_name])
                           + params[lp.b_name], lp.act)
        return y

    adv = chain(hp.adv, h)
    if hp.dueling:
        mean = adv.new_zeros(adv.shape[0])
        for k in range(hp.num_actions):
            mean = mean + adv[:, k]
        q = chain(hp.val, h) + adv - (mean * (1.0 / hp.num_actions))[:, None]
    else:
        q = adv
    return _collect_rest(env, plan, q, new, obs=obs, state=state,
                         ep_step=ep_step, ep_ret=ep_ret, u=u, eps=eps,
                         max_episode_length=max_episode_length,
                         tile=plan.tile)


def fused_collect_cuda(env, plan: CollectPlan, params, *, obs, state,
                       ep_step, ep_ret, u, eps,
                       max_episode_length: int):
    """Launch K4 (``ceil(E / plan.tile)`` blocks) on the current stream;
    the kernel reads ε from ``eps``'s device memory."""
    E = obs.shape[0]
    obs = obs.reshape(E, -1).float().contiguous()
    state = state.float().contiguous()
    ep_step = ep_step.to(torch.int32).contiguous()
    ep_ret = ep_ret.float().contiguous()
    u = u[:plan.n_uniforms].float().contiguous()
    eps = eps_tensor(eps, obs.device)
    tensors = [params[n] for n in plan.net.names]
    build.require_cuda(obs, state, ep_step, ep_ret, u, eps, *tensors)
    build.require_plan_params(plan.net, tensors)
    build.require_shape(obs, (E, plan.no), "obs")
    build.require_shape(state, (E, plan.W), "state")
    dev = obs.device
    fields = torch.empty(E, plan.nf, dtype=torch.float32, device=dev)
    obs_out = torch.empty_like(obs)
    state_out = torch.empty_like(state)
    ep_step_out = torch.empty_like(ep_step)
    ep_ret_out = torch.empty_like(ep_ret)
    nblk = -(-E // plan.tile)
    partials = torch.empty(nblk, 3, dtype=torch.float32, device=dev)
    err = build.library().dq_fused_collect(
        plan.net.desc(), build.int64_array([t.data_ptr() for t in tensors]),
        env_desc(env), obs.data_ptr(), state.data_ptr(),
        ep_step.data_ptr(), ep_ret.data_ptr(), u.data_ptr(), E, plan.tile,
        eps.data_ptr(), int(max_episode_length), fields.data_ptr(), obs_out.data_ptr(),
        state_out.data_ptr(), ep_step_out.data_ptr(), ep_ret_out.data_ptr(),
        partials.data_ptr(), build.stream_ptr(dev))
    build.check(err, "fused_collect")
    return (fields, obs_out, state_out, ep_step_out, ep_ret_out,
            partials.sum(dim=0))


def fused_collect_rnn_cuda(env, plan: CollectPlan, params, *, obs, state,
                           ep_step, ep_ret, u, eps,
                           max_episode_length: int, nstate):
    """Launch K6 (``ceil(E / plan.tile)`` blocks) on the current stream;
    the kernel reads ε from ``eps``'s device memory."""
    E = obs.shape[0]
    obs = obs.reshape(E, -1).float().contiguous()
    state = state.float().contiguous()
    ep_step = ep_step.to(torch.int32).contiguous()
    ep_ret = ep_ret.float().contiguous()
    u = u[:plan.n_uniforms].float().contiguous()
    nstate = nstate.float().contiguous()
    eps = eps_tensor(eps, obs.device)
    tensors = [params[n] for n in plan.net.names]
    wi, wh, b = (params[n] for n in plan.cell.names)
    build.require_cuda(obs, state, ep_step, ep_ret, u, nstate, eps, wi, wh,
                       b, *tensors)
    build.require_plan_params(plan.net, tensors)
    cp = plan.cell
    g = cp.n_gates * cp.hidden
    build.require_shape(wi, (cp.in_dim, g), cp.names[0])
    build.require_shape(wh, (cp.hidden, g), cp.names[1])
    build.require_shape(b, (g,), cp.names[2])
    build.require_shape(obs, (E, plan.no), "obs")
    build.require_shape(state, (E, plan.W), "state")
    build.require_shape(nstate, (E, plan.state_width), "nstate")
    dev = obs.device
    fields = torch.empty(E, plan.nf, dtype=torch.float32, device=dev)
    obs_out = torch.empty_like(obs)
    state_out = torch.empty_like(state)
    ep_step_out = torch.empty_like(ep_step)
    ep_ret_out = torch.empty_like(ep_ret)
    nstate_out = torch.empty_like(nstate)
    nblk = -(-E // plan.tile)
    partials = torch.empty(nblk, 3, dtype=torch.float32, device=dev)
    err = build.library().dq_fused_collect_rnn(
        plan.net.desc(), build.int64_array([t.data_ptr() for t in tensors]),
        0 if cp.kind == "lstm" else 1, cp.hidden, cp.in_dim, wi.data_ptr(),
        wh.data_ptr(), b.data_ptr(), env_desc(env), obs.data_ptr(),
        state.data_ptr(),
        ep_step.data_ptr(), ep_ret.data_ptr(), u.data_ptr(),
        nstate.data_ptr(), E, plan.tile, eps.data_ptr(),
        int(max_episode_length),
        fields.data_ptr(), obs_out.data_ptr(), state_out.data_ptr(),
        ep_step_out.data_ptr(), ep_ret_out.data_ptr(), nstate_out.data_ptr(),
        partials.data_ptr(), build.stream_ptr(dev))
    build.check(err, "fused_collect (recurrent)")
    return (fields, obs_out, state_out, ep_step_out, ep_ret_out,
            partials.sum(dim=0), nstate_out)


def eps_tensor(eps, device) -> torch.Tensor:
    """ε as the 0-d f32 tensor on ``device`` that the kernels read (K4 and
    K6 take a device pointer, as the JAX kernel takes an array): a tensor
    as it is, a Python number made into one by a fill."""
    if torch.is_tensor(eps):
        if eps.dim() != 0 or eps.dtype != torch.float32 or \
                eps.device != torch.device(device):
            raise ValueError(f"eps must be a 0-d float32 tensor on {device}, "
                             f"got {tuple(eps.shape)} {eps.dtype} on "
                             f"{eps.device}")
        return eps
    return torch.full((), float(eps), dtype=torch.float32, device=device)


def fused_collect(env, plan: CollectPlan, params, *, obs, state, ep_step,
                  ep_ret, u, eps, max_episode_length: int,
                  nstate=None):
    """One collect step over all E envs.

    ``obs [E, no]``, ``state [E, W]`` (the env's batched state), ``ep_step
    [E]`` int32, ``ep_ret [E]`` f32, ``u [plan.n_uniforms, E]`` uniforms,
    ``eps`` a 0-d f32 tensor on obs' device (a Python number is made into
    one, :func:`eps_tensor`); a recurrent plan also takes the cell's state rows
    ``nstate [E, S]`` (h;c for LSTM, h for GRU). Returns ``(fields [E,
    2no+4], obs' [E, no], state' [E, W], ep_step' [E] int32, ep_ret' [E],
    totals [3])`` with totals = (ended return sum, ended length sum, ended
    count), and for a recurrent plan a trailing ``nstate' [E, S]``, zero
    where the episode ended."""
    E = obs.shape[0]
    nu = plan.n_uniforms
    if u.dim() != 2 or u.shape[0] < nu or u.shape[1] != E:
        raise ValueError(f"u must be [{nu}, E={E}] uniforms, got "
                         f"{tuple(u.shape)}")
    if state.shape[0] != E or ep_step.shape[0] != E or ep_ret.shape[0] != E:
        raise ValueError("obs, state, ep_step and ep_ret must share E")
    kw = dict(obs=obs, state=state, ep_step=ep_step, ep_ret=ep_ret, u=u,
              eps=eps_tensor(eps, obs.device),
              max_episode_length=max_episode_length)
    if plan.cell is not None:
        if nstate is None or tuple(nstate.shape) != (E, plan.state_width):
            raise ValueError(f"a recurrent plan needs nstate [E={E}, "
                             f"{plan.state_width}]")
        fn = fused_collect_rnn_cuda if obs.is_cuda else fused_collect_plain
        return fn(env, plan, params, nstate=nstate, **kw)
    fn = fused_collect_cuda if obs.is_cuda else fused_collect_plain
    return fn(env, plan, params, **kw)
