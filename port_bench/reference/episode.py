"""A plain episode replay for DRQN (Hausknecht & Stone 2015), with the
port's documented semantics (``replay/episode.py``'s docstring):

* every lockstep step writes one row per env into a ring of ``R`` steps
  (row ``t mod R``): obs, next obs, and the f32 action, reward and done;
* an env whose episode ended (done, or ``max_episode_length`` steps)
  commits a record ``(start, length)`` of global steps into its own ring of
  ``M`` records (slot ``count mod M``); the open episode's length starts at
  0 again;
* a draw of ``D`` windows of ``T`` steps takes, per window, an env in
  proportion to its stored records (the first env whose running count of
  records exceeds ``u · total`` in f32), one of its records (a raw int
  modulo the records it holds), a record the ring has overwritten (``t -
  start > R - length``) replaced by the env's newest, and a start inside
  the episode (a raw int modulo its length); steps past the episode's end
  are zero in every field and masked out (``mask`` 0).

Departures from the published DRQN, the port's: a window starts anywhere
in an episode and is zero-padded past its end, in place of a random
window of a fixed length over the whole replay; episodes are drawn with
equal weight (DeepQLearning.jl draws a prefix of an episode instead,
``SURVEY.md`` C7). The ring's rows are read modulo ``R``, where the port
mirrors its first ``T - 1`` rows after the ring; the counters are host
ints and exact integer tensors.
"""
from __future__ import annotations

import torch


class EpisodeRing:
    """The ring, its records and the step counter ``t`` from a snapshot of
    the measured program's replay (``ring_obs``, ``ring_next_obs``,
    ``ring_scalars [R, E, .]``, ``ep_start``, ``ep_len [E, M]``,
    ``rec_count``, ``cur_len [E]`` and ``ring_t``), on ``device``."""

    def __init__(self, snap, device):
        self.obs = snap["ring_obs"].to(device).clone()
        self.next_obs = snap["ring_next_obs"].to(device).clone()
        self.scalars = snap["ring_scalars"].to(device).clone()
        self.R = self.obs.shape[0]
        self.ep_start = snap["ep_start"].to(device).long()
        self.ep_len = snap["ep_len"].to(device).long()
        self.rec_count = snap["rec_count"].to(device).long()
        self.cur_len = snap["cur_len"].to(device).long()
        self.E, self.M = self.ep_start.shape
        self.t = int(snap["ring_t"])

    def add(self, obs, action, reward, next_obs, done, ended) -> int:
        """Write one step of every env; returns the ring row written."""
        E, k = self.E, self.t % self.R
        self.obs[k] = obs.reshape(E, -1).to(self.obs.dtype)
        self.next_obs[k] = next_obs.reshape(E, -1).to(self.obs.dtype)
        self.scalars[k] = torch.stack(
            [action.float(), reward.float(), done.float(),
             torch.zeros_like(reward, dtype=torch.float32)], dim=1)
        length = self.cur_len + 1
        env = torch.nonzero(ended).flatten()
        slot = self.rec_count[env] % self.M
        self.ep_start[env, slot] = self.t - length[env] + 1
        self.ep_len[env, slot] = length[env]
        self.rec_count[env] += 1
        self.cur_len = torch.where(ended, 0, length)
        self.t += 1
        return k

    def records(self) -> dict:
        return dict(ep_start=self.ep_start, ep_len=self.ep_len,
                    rec_count=self.rec_count, cur_len=self.cur_len)

    def sample(self, T: int, env_u, raw_rec, raw_start):
        """``(obs, next_obs [D, T, no], action, reward, done, mask [D,
        T])`` of ``D`` windows from the draws (module docstring)."""
        M, R = self.M, self.R
        held = self.rec_count.clamp(max=M)
        running = torch.cumsum(held, dim=0).float()
        mass = env_u.float() * running[-1].clamp(min=1.0)
        env = torch.bucketize(mass, running, right=True).clamp(
            max=self.E - 1)
        n = held[env].clamp(min=1)
        rec = raw_rec.long() % n
        start, length = self.ep_start[env, rec], self.ep_len[env, rec]
        stale = (self.t - start) > (R - length.clamp(min=1))
        rec = torch.where(stale, (self.rec_count[env] - 1) % n, rec)
        start = self.ep_start[env, rec]
        length = self.ep_len[env, rec].clamp(min=1)
        off = raw_start.long() % length
        steps = torch.arange(T, device=env.device)
        valid = steps[None, :] < (length - off)[:, None]
        rows = (start + off)[:, None] + steps[None, :]
        rows, env = rows % R, env[:, None]

        def field(x):
            w = x[rows, env]
            keep = valid.reshape(valid.shape + (1,) * (w.dim() - 2))
            return torch.where(keep, w, torch.zeros((), dtype=w.dtype,
                                                    device=w.device))

        sc = field(self.scalars)
        return (field(self.obs), field(self.next_obs), sc[..., 0].long(),
                sc[..., 1], sc[..., 2], valid.float())
