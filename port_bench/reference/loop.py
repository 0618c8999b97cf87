"""The plain actor-learner iteration of double-Q dueling DQN with
prioritized replay (Mnih et al. 2015; van Hasselt et al. 2016; Wang et al.
2016; Schaul et al. 2016), in plain PyTorch.

One iteration: one ε-greedy step of every env (a uniform random action
with probability ε, else the first greedy action), the transitions into
the replay; then ``U`` sequential Adam updates on ``U`` sub-batches of one
stratified draw (the target net's Q(s') for all of them first), each
minimising ``Σ huber(w·td) / B`` with ``td = Q(s, a) - (r + (1 - d) γ
Q_target(s', argmax_a Q(s', a)))``, then one priority update from all of
their TD errors; then a hard target sync when the env steps since the
last one reach the period. Adam is optax's (β 0.9 / 0.999, ε 1e-8, bias
corrected), each operation in the parameters' dtype, its constants
rounded to that dtype.

Random numbers: the same ``torch.Generator`` stream as the measured loop,
drawn in the same calls. Where the port's fused collect (K4) runs, an
f32 network of layers it runs over an env it has device code for, the
collect takes one draw of ``[2 + ns + nr, E]`` uniforms (explore, random
action, the env's ``ns`` step and ``nr`` reset uniforms); otherwise a
random action (``randint``), then the explore test (``rand``), then the
env's step uniforms ``[ns, E]`` and its reset uniforms ``[nr, E]``, each
where the env has any. A train call draws ``U·B`` uniforms.

``Follow`` runs the iterations from a snapshot of the measured loop's
state; it judges the rows that loop inserted and the priorities it left
against its own as it goes (``judge``), and where the loop's choice was
one of two that a rounding apart could swap, it takes the loop's, once
judged: a greedy action whose Q value lies within ``TIE_ULPS`` units in
the last place of the best, and the double-Q action of a row whose two
best Q(s') values lie that close, read from the TD error behind the
loop's priority of the row. The unit in the last place is the dtype's at
the row's scale, the largest magnitude among its V, A and Q values, where
the dueling sum rounds. Without that, one such swap in a bf16 loop (whose
online and target nets part within a few updates) moves every later update
apart. Each run reports how many it took (``actions_excused``,
``ties_followed``), the widest such gap it saw in ulps, taken or not
(``greedy_ulps``, ``double_q_ulps``), and how many greedy actions it
compared (``greedy_checked``).

The env and the network come from the files of their kinds
(``envs/<kind>.py``, ``layers/<kind>.py``) through ``parts``, the
benchmark's registry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .nets import Net, Precision
from .replay import Replay

# the tie tolerance in units in the last place of the row's scale, by
# dtype: sound runs on the card swapped no f32 choice and no bf16 choice
# more than 1 ulp apart
TIE_ULPS = {"float32": 4, "bfloat16": 4}
MANTISSA = {"float32": 23, "bfloat16": 7}


def epsilon(sched, t: torch.Tensor) -> torch.Tensor:
    """ε(t) of a linear decay, in f32 as the measured loop computes it."""
    f32 = np.float32
    steps = float(f32(max(sched["steps"], 1)))
    frac = torch.clamp(t.to(torch.float32) / torch.full(
        (), steps, dtype=torch.float32, device=t.device), 0.0, 1.0)
    return float(f32(sched["start"])) - float(
        f32(sched["start"] - sched["stop"])) * frac


def ulp(dtype: str, scale: torch.Tensor) -> torch.Tensor:
    """The unit in the last place of ``dtype`` at magnitude ``scale``."""
    _m, e = torch.frexp(scale.float().clamp(min=2.0 ** -100))
    return torch.ldexp(torch.ones_like(scale, dtype=torch.float32),
                       e - 1 - MANTISSA[dtype])


def _differ(ours, theirs, n: int, device) -> int:
    """Rows of ``n`` that differ in any field between two tuples of
    tensors with ``n`` leading rows."""
    bad = torch.zeros(n, dtype=torch.bool, device=device)
    for a, b in zip(ours, theirs):
        bad |= ~(a == b.to(device)).reshape(n, -1).all(dim=1)
    return int(bad.sum())


class Adam:
    """optax's Adam in the parameters' dtype (module docstring)."""

    def __init__(self, lr, params):
        self.lr = lr
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @staticmethod
    def _consts(dtype, lr):
        return tuple(torch.tensor(x, dtype=dtype).item() for x in (
            0.1, 0.9, 1.0 - 0.999, 0.999, 1e-8, -lr))

    @torch.no_grad()
    def step(self, grads, params):
        self.count += 1
        dev = next(iter(params.values())).device
        t = torch.tensor(float(self.count), device=dev)
        bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        for k, g in grads.items():
            m, v, p = self.m[k], self.v[k], params[k]
            c1, b1, c2, b2, eps, neg_lr = self._consts(p.dtype, self.lr)
            m.mul_(b1).add_(c1 * g)
            v.mul_(b2).add_(c2 * (g * g))
            p.add_(neg_lr * ((m / bc1.to(m.dtype))
                             / (torch.sqrt(v / bc2.to(v.dtype)) + eps)))


class Follow:
    """The reference's iterations from the snapshot ``snap`` (a dict of
    tensors: ``params``, ``target``, ``env_state``, ``obs``, ``ep_step``,
    ``t``, ``sync_acc``, the replay's rows split into ``rows_obs``,
    ``rows_next_obs``, ``rows_scalars`` and its ``tree``, ``pos``,
    ``size``, and the generator's ``gen_state``), on ``device``.

    ``prec`` is the precision of the products (``nets.Precision``);
    ``fault`` plants one fault where the reference stands in for the
    program (``"half_batch"``, ``"altered"``) and is None otherwise.
    ``reference/drqn.py`` takes the replay, the collect's Q and its store
    over (``_init_replay``, ``_act_q``, ``_store``, ``_end_step``) and the
    train step, for a recurrent loop over an episode replay."""

    def __init__(self, spec, traffic, snap, device, parts, prec=None,
                 fault=None, keep_rows=False):
        self.spec, self.tr, self.dev = spec, traffic, device
        self.keep_rows, self.rows = keep_rows, []
        self.prec = prec or Precision()
        self.fault = fault
        self.envmod = parts.env(spec["env"]["kind"])
        self.env = self.envmod.Reference(spec["env"], device)
        self.net = Net(spec["net"], parts, self.env.obs_shape)
        # the port draws the collect's uniforms as one block where its
        # fused collect (K4) runs the env and the network in f32
        self.fused = (spec["dtype"] == "float32" and self.envmod.FUSED_COLLECT
                      and self.net.fused_collect())
        self.ns, self.nr = self.envmod.STEP_UNIFORMS, \
            self.envmod.RESET_UNIFORMS
        self.tie_ulps = TIE_ULPS[spec["dtype"]]
        self.params = {k: v.to(device).clone()
                       for k, v in snap["params"].items()}
        self.target = {k: v.to(device).clone()
                       for k, v in snap["target"].items()}
        self.adam = Adam(spec["learning_rate"], self.params)
        self.state = snap["env_state"].to(device).clone()
        self.obs = snap["obs"].to(device).clone()
        self.ep_step = snap["ep_step"].to(device).clone()
        self.t = int(snap["t"])
        self.sync_acc = int(snap["sync_acc"])
        self.gen = torch.Generator(device=device)
        self.gen.set_state(snap["gen_state"])
        self.rows_bad = 0
        self.actions_excused = 0
        self.ties_followed = 0
        self.greedy_ulps = 0.0
        self.double_q_ulps = 0.0
        self.greedy_checked = 0
        self._init_replay(spec, traffic, snap, device)

    def _init_replay(self, spec, traffic, snap, device):
        C = traffic["buffer_size"]
        n = int(snap["rows_obs"].shape[0])
        sdt = getattr(torch, spec["dtype"])
        no = snap["rows_obs"].shape[1]
        obs = torch.zeros(C, no, dtype=sdt, device=device)
        nobs = torch.zeros(C, no, dtype=sdt, device=device)
        sc = torch.zeros(C, 4, dtype=torch.float32, device=device)
        obs[:n] = snap["rows_obs"].to(device)
        nobs[:n] = snap["rows_next_obs"].to(device)
        sc[:n] = snap["rows_scalars"].to(device)
        tree = tuple(x.to(device).clone() for x in snap["tree"])
        self.replay = Replay(obs, nobs, sc, tree, snap["pos"], snap["size"],
                             spec["per"], self.env.obs_shape)
        self.prio_gap = 0.0
        self.td1_gap = None

    # -- collect -------------------------------------------------------
    def _gap_ulps(self, q, scale, chosen, best):
        """How far ``chosen``'s Q value lies below ``best``'s, per row, in
        units in the last place at the row's scale."""
        qf = q.float()
        chosen = chosen.clamp(0, q.shape[1] - 1)
        gap = qf.gather(1, best[:, None])[:, 0] - qf.gather(
            1, chosen[:, None])[:, 0]
        return gap / ulp(self.spec["dtype"], scale)

    def collect(self, judge: Optional[Dict[str, torch.Tensor]] = None):
        env, E = self.env, self.obs.shape[0]
        A = env.num_actions
        tt = torch.tensor(self.t, dtype=torch.int64, device=self.dev)
        eps = epsilon(self.spec["exploration"], tt)
        with torch.no_grad():
            q, scale = self._act_q()
        ns, nr = self.ns, self.nr
        greedy = torch.argmax(q, dim=1)
        if self.fused:
            u = torch.rand(2 + ns + nr, E, generator=self.gen,
                           device=self.dev)
            explore = u[0] < eps
            action = torch.where(explore, torch.floor(u[1] * float(A)).long(),
                                 greedy)
            step_u, reset_u = u[2:2 + ns], u[2 + ns:]
        else:
            rand = torch.randint(0, A, (E,), generator=self.gen,
                                 device=self.dev)
            explore = torch.rand(E, generator=self.gen,
                                 device=self.dev) < eps
            action = torch.where(explore, rand, greedy)
            step_u = (torch.rand(ns, E, generator=self.gen, device=self.dev)
                      if ns else None)
        if judge is not None:
            theirs = judge["action"].to(self.dev).long()
            differ = (theirs != action) & ~explore
            ok = (theirs >= 0) & (theirs < A)
            gap = self._gap_ulps(q, scale, theirs, greedy)
            if bool((differ & ok).any()):
                self.greedy_ulps = max(self.greedy_ulps,
                                       float(gap[differ & ok].max()))
            excuse = differ & ok & (gap <= self.tie_ulps)
            self.actions_excused += int(excuse.sum())
            self.greedy_checked += int((~explore).sum())
            action = torch.where(excuse, theirs, action)
        new_state, nobs, r, done = env.step(self.state, action, step_u)
        if self.fault == "altered":
            r = r.clone()
            r[0] += 1.0
        ended = (done > 0.5) | (self.ep_step + 1 >= self.tr[
            "max_episode_length"])
        self._store(action, r, nobs, done, ended, judge)
        if not self.fused:
            reset_u = (torch.rand(nr, E, generator=self.gen, device=self.dev)
                       if nr else None)
        r_state, r_obs = env.reset(reset_u, E)
        end = ended.reshape((E,) + (1,) * (new_state.dim() - 1))
        self.state = torch.where(end, r_state, new_state)
        endo = ended.reshape((E,) + (1,) * (nobs.dim() - 1))
        self.obs = torch.where(endo, r_obs, nobs)
        self.ep_step = torch.where(ended, 0, self.ep_step + 1).to(
            torch.int32)
        self.t = min(self.t + E, 1 << 30)
        self._end_step(ended, judge)

    def _act_q(self):
        """The collect's ``(Q, scale)`` of the envs' observations."""
        return self.net.q(self.params, self.obs, self.prec)

    def _store(self, action, r, nobs, done, ended, judge):
        """Insert the step's transitions; keep them (``keep_rows``) and
        count those that differ from the loop's (``judge``)."""
        E = action.shape[0]
        idx = self.replay.insert(self.obs, action, r, nobs, done)
        if self.keep_rows:
            sc = self.replay.scalars[idx].cpu()
            self.rows.append(dict(obs=self.replay.obs[idx].cpu(),
                                  next_obs=self.replay.next_obs[idx].cpu(),
                                  scalars=sc, action=sc[:, 0]))
        if judge is not None:
            ours = (self.replay.obs[idx], self.replay.next_obs[idx],
                    self.replay.scalars[idx])
            theirs = (judge["obs"], judge["next_obs"], judge["scalars"])
            self.rows_bad += _differ(ours, theirs, E, self.dev)

    def _end_step(self, ended, judge):
        """After a collect step: nothing to carry in a feed-forward loop."""

    # -- train ---------------------------------------------------------
    def _q(self, params, x):
        return self.net.q(params, x, self.prec)

    def _follow_ties(self, q_onl, scale, q_sa, q_tgt, rew, done, gamma,
                     theirs, visible):
        """The double-Q action of each row: the reference's argmax of
        Q(s'), or where its two best values lie within ``TIE_ULPS`` and the
        loop's priority of the row shows, clearly, that the loop took the
        other of the two (its TD error), that one."""
        best = torch.argmax(q_onl, dim=1)
        if theirs is None:
            return best
        top = torch.topk(q_onl.float(), 2, dim=1).indices
        other = torch.where(top[:, 0] == best, top[:, 1], top[:, 0])
        per = self.spec["per"]
        prio = []
        for c in (best, other):
            t = rew + (1.0 - done) * gamma * q_tgt.gather(1, c[:, None])[:, 0]
            prio.append((q_sa - t).abs().add(per["eps"]) ** per["alpha"])
        took_other = (prio[1] - theirs).abs() < 0.5 * (
            prio[0] - theirs).abs()
        seen = took_other & visible
        gap = self._gap_ulps(q_onl, scale, other, best)
        if bool(seen.any()):
            self.double_q_ulps = max(self.double_q_ulps,
                                     float(gap[seen].max()))
        take = seen & (gap <= self.tie_ulps)
        self.ties_followed += int(take.sum())
        return torch.where(take, other, best)

    def train(self, judge=None):
        U, B = self.tr["updates_per_iter"], self.tr["batch_size"]
        gamma = self.spec["env"]["discount"]
        u = torch.rand(U * B, generator=self.gen, device=self.dev)
        idx, obs, act, rew, nobs, done, w = self.replay.sample(U, B, u)
        theirs = visible = None
        if judge is not None and "tree" in judge:
            # the loop's priority of each draw, where no later draw of the
            # same leaf in this iteration overwrote it
            theirs = judge["tree"][0].to(self.dev)[idx]
            pos = torch.arange(idx.shape[0], device=self.dev)
            last = torch.full((self.replay.tree[0].shape[0],), -1,
                              dtype=pos.dtype, device=self.dev)
            last.scatter_reduce_(0, idx, pos, reduce="amax")
            visible = last[idx] == pos
        # the first sub-batch's leaves that no later sub-batch rewrites
        later = torch.zeros(self.replay.tree[0].shape[0], dtype=torch.bool,
                            device=self.dev)
        later[idx[B:]] = True
        self.first_idx = idx[:B][~later[idx[:B]]]
        with torch.no_grad():
            q_tgt_all = self._q(self.target, nobs)[0].float()
        tds, loss = [], None
        for k in range(U):
            sl = slice(k * B, (k + 1) * B)
            with torch.no_grad():
                q_onl, scale = self._q(self.params, nobs[sl])
            p = {n: v.detach().requires_grad_() for n, v in
                 self.params.items()}
            q = self._q(p, obs[sl])[0].float()
            a = act[sl]
            mask = torch.arange(q.shape[1], device=self.dev) == a[:, None]
            q_sa = torch.where(mask, q, 0.0).sum(dim=-1)
            best = self._follow_ties(
                q_onl, scale, q_sa.detach(), q_tgt_all[sl], rew[sl], done[sl], gamma,
                None if theirs is None else theirs[sl],
                None if visible is None else visible[sl])
            q_sp = q_tgt_all[sl].gather(1, best[:, None])[:, 0]
            target = rew[sl] + (1.0 - done[sl]) * gamma * q_sp
            td = q_sa - target
            x = w[sl] * td
            absx = x.abs()
            quad = absx.clamp(max=1.0)
            huber = 0.5 * quad * quad + (absx - quad)
            if self.fault == "half_batch":
                loss = huber[:B // 2].sum() * (1.0 / (B // 2))
            else:
                loss = huber.sum() * (1.0 / B)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            self.adam.step(grads, self.params)
            tds.append(td.detach())
        self.replay.update(idx, torch.cat(tds))
        self.loss = float(loss.detach())

    def sync(self):
        self.sync_acc += self.tr["env_steps_per_iter"]
        if self.sync_acc >= self.tr["target_update_freq"]:
            self.target = {k: v.clone() for k, v in self.params.items()}
        self.sync_acc %= self.tr["target_update_freq"]

    def judge_priorities(self, tree):
        """Judge the loop's priorities after an iteration, then take
        them, as a served model's tokens are taken once judged: a
        stratified draw from leaves a rounding apart can land one leaf
        over, and the iterations that follow would then train on other
        rows. ``prio_gap``: the relative L2 gap of all leaves, the largest
        over the iterations; ``td1_gap``: the same over the leaves that the
        first iteration's first sub-batch wrote (and no later sub-batch
        rewrote), the TD errors of the first update from the parameters
        both sides start from."""
        theirs = tuple(x.to(self.dev).clone() for x in tree)
        ours = self.replay.tree[0]
        diff = theirs[0] - ours
        first = self.first_idx
        self.prio_gap = max(self.prio_gap, float(
            diff.double().norm() / ours.double().norm()))
        if self.td1_gap is None:
            self.td1_gap = float(diff[first].double().norm()
                                 / ours[first].double().norm())
        self.replay.tree = theirs

    def judged(self) -> dict:
        """The numbers judged as the iterations went (``harness/check.py``):
        ``prio_gap``, ``td1_gap`` (None before any update) and
        ``rows_bad``."""
        return dict(prio_gap=float(self.prio_gap),
                    td1_gap=(math.nan if self.td1_gap is None
                             else float(self.td1_gap)),
                    rows_bad=float(self.rows_bad))

    def end_state(self) -> dict:
        """What a step left unchanged is read against: the priorities."""
        return dict(tree=self.replay.tree)

    def tie_readings(self) -> dict:
        return dict(actions_excused=self.actions_excused,
                    ties_followed=self.ties_followed,
                    greedy_ulps=self.greedy_ulps,
                    double_q_ulps=self.double_q_ulps,
                    greedy_checked=self.greedy_checked)

    def iteration(self, judge=None):
        self.collect(judge)
        self.train(judge)
        if self.keep_rows:
            self.rows[-1]["tree"] = [x.detach().cpu().clone()
                                     for x in self.replay.tree]
        if judge is not None and "tree" in judge:
            self.judge_priorities(judge["tree"])
        self.sync()
        return self.loss


def follow(spec, traffic, snap, device, steps: List[Optional[dict]],
           parts, prec=None, fault=None, keep_rows=False):
    """Run ``len(steps)`` iterations from ``snap`` (``steps[k]``: the
    measured loop's rows of iteration ``k``, or None); returns a dict
    with each iteration's ``loss``, Adam's first moment ``m1`` after the
    first, the ``params`` and ``target`` after the last, the numbers
    ``judged`` as it went (``Follow.judged``), what a step left unchanged
    is read against (``Follow.state``: the priority ``tree``, or a
    recurrent loop's ``hidden`` states) and the tie readings (module
    docstring); with ``keep_rows`` also what it inserted (``rows``), per
    iteration. A configuration with ``recurrence`` takes the recurrent
    loop (``reference/drqn.py``), any other this module's. ``parts``
    finds the env's and the layers' files (the benchmark's registry)."""
    if "recurrence" in spec:
        from .drqn import FollowRecurrent as cls
    else:
        cls = Follow
    f = cls(spec, traffic, snap, device, parts, prec, fault, keep_rows)
    out = {"loss": []}
    for k, judge in enumerate(steps):
        out["loss"].append(f.iteration(judge))
        if k == 0:
            out["m1"] = {n: v.clone() for n, v in f.adam.m.items()}
    out.update(params=f.params, target=f.target, judged=f.judged(),
               ties=f.tie_readings(), rows=f.rows, **f.end_state())
    return out
