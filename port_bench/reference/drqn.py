"""The plain actor-learner iteration of double-Q dueling DRQN (Hausknecht
& Stone 2015; van Hasselt et al. 2016; Wang et al. 2016) over an episode
replay (``reference/episode.py``), in plain PyTorch.

One iteration: one ε-greedy step of every env from the network's
recurrent state, which each env carries from step to step and which is
zero again once its episode ended; the transitions into the ring, the
ended episodes' records committed; then ``U`` sequential Adam updates on
``U`` sub-batches of one draw of ``U·B`` windows of ``T`` steps, the target
net's Q(s') of all of them first. Every window is unrolled from a zero
state, both on s and on s'; each update minimises ``Σ_b Σ_t huber(m·td) /
(B·T)`` with ``m`` the window's validity mask and ``td = Q(s, a) - (r + (1
- d) γ Q_target(s', argmax_a Q(s', a)))``; then a hard target sync when the
env steps since the last one reach the period. Adam is
``reference/loop.py``'s.

Departures from the published DRQN, the port's: the unroll of a window
starts from a zero state (DRQN's bootstrapped random updates do so too,
but over windows of a fixed length drawn from anywhere in an episode,
where these start anywhere and are zero-padded past its end, masked); the
loss is the Huber loss of double-Q, normalised by ``B·T`` whatever the
mask, where DRQN takes the squared TD error of plain Q-learning; the
dueling head (Wang et al. 2016) sits on the cell's output.

Random numbers: the same ``torch.Generator`` stream as the measured loop,
drawn in the same calls. The collect draws as ``reference/loop.py``'s (one
block of ``[2 + ns + nr, E]`` uniforms where the port's recurrent collect,
K6, runs); a train call draws the episode replay's ``sample_n``: ``U·B``
uniforms (the env mass), then ``U·B`` raw ints for the record and ``U·B``
for the start, each in ``[0, 2^30)``.

Judged as it goes against the measured loop's own rows
(``harness/check.py``): ``rows_bad`` and ``hidden_gap``. The greedy
actions follow the loop's within ``TIE_ULPS`` as ``reference/loop.py``'s;
the double-Q argmax has no reading of the loop's to follow (no
priorities), so the run counts the window steps whose two best Q(s')
values lie within ``TIE_ULPS`` of each other (``double_q_near``): a swap
there moves the target by the target net's gap between the two actions,
which a target synced every iteration keeps near that of the online net.
"""
from __future__ import annotations

import torch

from .episode import EpisodeRing
from .loop import Follow, _differ, ulp


class FollowRecurrent(Follow):
    """``Follow`` over an episode replay with a recurrent network: the
    snapshot also holds the ring and its records (``EpisodeRing``) and the
    actor's recurrent state ``hidden [E, .]`` (each state tensor side by
    side, an LSTM's ``h`` then ``c``). Faults planted where it stands in
    for the program, besides ``Follow``'s ``half_batch`` and ``altered``:
    ``no_reset`` (the state not zeroed at an episode's end),
    ``skip_update`` (the last sub-update left out), ``no_mask`` (the mask
    left out of the loss)."""

    def _init_replay(self, spec, traffic, snap, device):
        self.ring = EpisodeRing(snap, device)
        self.T = traffic["trace_length"]
        # the base's state (``Net.init_state``'s form) from the loop's,
        # whose tensors lie side by side in ``hidden``
        zero = self.net.init_state(self.obs.shape[0], self.obs.dtype, device)
        parts = iter(snap["hidden"].to(device).split(
            [x.shape[1] for s in zero if s is not None for x in s], dim=1))
        self.cell_state = [None if s is None else
                           tuple(next(parts).clone() for _ in s)
                           for s in zero]
        self.hidden_gap = 0.0
        self.hidden = []
        self.double_q_near = 0

    # -- collect -------------------------------------------------------
    def _act_q(self):
        q, scale, self._next_state = self.net.q(
            self.params, self.obs, self.prec, self.cell_state)
        return q, scale

    def _store(self, action, r, nobs, done, ended, judge):
        E = action.shape[0]
        ring = self.ring
        k = ring.add(self.obs, action, r, nobs, done, ended)
        ours = (ring.obs[k], ring.next_obs[k], ring.scalars[k])
        if self.keep_rows:
            host = lambda x: x.to("cpu", copy=True)  # noqa: E731
            self.rows.append(dict(obs=host(ours[0]), next_obs=host(ours[1]),
                                  scalars=host(ours[2]),
                                  action=host(ours[2][:, 0]),
                                  **{n: host(v) for n, v in
                                     ring.records().items()}))
        if judge is not None:
            theirs = (judge["obs"], judge["next_obs"], judge["scalars"])
            self.rows_bad += _differ(ours, theirs, E, self.dev)
            recs = ring.records()
            self.rows_bad += _differ(
                tuple(recs.values()),
                tuple(judge[n].long() for n in recs), E, self.dev)

    def _end_step(self, ended, judge):
        """The cell's new state, zero where the episode ended; judged
        against the loop's (``hidden_gap``)."""
        keep = ~ended[:, None] | (self.fault == "no_reset")
        self.cell_state = [None if s is None else
                           tuple(torch.where(keep, x, torch.zeros_like(x))
                                 for x in s) for s in self._next_state]
        ours = torch.cat([x for s in self.cell_state if s is not None
                          for x in s], dim=1)
        self.hidden.append(ours.cpu())
        if self.keep_rows:
            self.rows[-1]["hidden"] = ours.cpu()
        if judge is not None:
            ref = ours.double()
            gap = (judge["hidden"].to(self.dev).double() - ref).norm() / \
                ref.norm().clamp(min=1e-30)
            self.hidden_gap = max(self.hidden_gap, float(gap))

    # -- train ---------------------------------------------------------
    def train(self, judge=None):
        U, B, T = self.tr["updates_per_iter"], self.tr["batch_size"], self.T
        gamma = self.spec["env"]["discount"]
        D, dev, g = U * B, self.dev, self.gen
        env_u = torch.rand(D, generator=g, device=dev)
        raw_rec = torch.randint(0, 1 << 30, (D,), generator=g, device=dev)
        raw_start = torch.randint(0, 1 << 30, (D,), generator=g, device=dev)
        obs, nobs, act, rew, done, mask = self.ring.sample(
            T, env_u, raw_rec, raw_start)
        shape = (D, T) + tuple(self.env.obs_shape)
        obs, nobs = obs.reshape(shape), nobs.reshape(shape)
        if self.fault == "no_mask":
            mask = torch.ones_like(mask)
        with torch.no_grad():
            q_tgt_all = self.net.unroll(self.target, nobs, self.prec)[
                0].float()
        loss = None
        n = U - 1 if self.fault == "skip_update" else U
        for k in range(n):
            sl = slice(k * B, (k + 1) * B)
            with torch.no_grad():
                q_onl, scale = self.net.unroll(self.params, nobs[sl],
                                               self.prec)
            best = torch.argmax(q_onl, dim=-1)
            top = torch.topk(q_onl.float(), 2, dim=-1).values
            near = (top[..., 0] - top[..., 1]) <= self.tie_ulps * ulp(
                self.spec["dtype"], scale)
            self.double_q_near += int((near & (mask[sl] > 0)).sum())
            p = {n_: v.detach().requires_grad_() for n_, v in
                 self.params.items()}
            q = self.net.unroll(p, obs[sl], self.prec)[0].float()
            a = act[sl]
            onehot = torch.arange(q.shape[-1], device=dev) == a[..., None]
            q_sa = torch.where(onehot, q, 0.0).sum(dim=-1)
            q_sp = q_tgt_all[sl].gather(-1, best[..., None])[..., 0]
            target = rew[sl] + (1.0 - done[sl]) * gamma * q_sp
            x = mask[sl] * (q_sa - target)
            absx = x.abs()
            quad = absx.clamp(max=1.0)
            huber = 0.5 * quad * quad + (absx - quad)
            if self.fault == "half_batch":
                loss = huber[:B // 2].sum() * (1.0 / (B // 2 * T))
            else:
                loss = huber.sum() * (1.0 / (B * T))
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            self.adam.step(grads, self.params)
        self.loss = float(loss.detach())

    def iteration(self, judge=None):
        self.collect(judge)
        self.train(judge)
        self.sync()
        return self.loss

    def judged(self) -> dict:
        return dict(rows_bad=float(self.rows_bad),
                    hidden_gap=float(self.hidden_gap))

    def end_state(self) -> dict:
        """What a step left unchanged is read against: the recurrent state
        after each iteration."""
        return dict(hidden=self.hidden)

    def tie_readings(self) -> dict:
        return dict(super().tie_readings(), double_q_near=self.double_q_near)
