"""Episode replay for the recurrent (DRQN) path, on the device.

Counterpart of ``deepqlearning_tpu.replay.episode``, with its semantics and
not its TPU layout: the JAX ring groups ``G`` envs into one row of up to
128 lanes, the TPU's lane tiling, which a GPU does not have, so the port
keeps one env per row slot (the same memory, ``convert.py``):

* every lockstep step writes one row ``t % R`` of a time-major ring
  ``[R + T - 1, E, F]`` in the storage dtype ``obs_dtype`` (any 1-, 2- or
  4-byte dtype), ``F = 2·no + 4·ratio`` with ``ratio = 4 / itemsize``:
  obs and next_obs cast to the storage dtype, then the four f32 scalars
  (action, reward, done, pad) bit-cast into ``4·ratio`` lanes, exact, as
  the PER rows (``replay/prioritized.py``); rows ``0..T-2`` are mirrored
  into ``T - 1`` shadow rows after the ring, so every trace window is one
  contiguous run of ``T`` rows;
* an env whose episode ended commits a ``(start, length)`` record into its
  own ring of ``M`` records;
* a sample draws episodes uniformly over all stored episodes (a
  ``searchsorted`` over the prefix sums of the envs' record counts, where
  the JAX package descends a count tree), a record of the
  drawn env, and a random start inside the episode; the window is
  zero-padded past the episode's end with a validity ``mask`` (every field
  of a masked step is zero; obs keep the storage dtype); a record
  whose rows the ring has overwritten is remapped to the env's newest one.

The ring and the index tensors are updated IN PLACE. The global step
counter ``t`` is a 0-d int64 tensor on the buffer's device, as every
counter of the loop's carry (``device.py::counter``), advanced by tensor
arithmetic; the ring row ``t % R``, its shadow row and the episode starts
are computed from it on the device and written through one-element index
tensors, with no branch, as the JAX package's ``dynamic_update_slice``
writes them. So no call reads the device, and a CUDA graph of an
iteration (``learner/segment.py``) writes each replay's transition into
the row of that replay's ``t``. Every random draw can be injected
(:class:`EpisodeDraws`): the env indices (or the uniforms of the record
mass), the raw record ints and the raw start ints.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import counter, resolve_device
from .prioritized import pack_scalars, storage_ratio, unpack_scalars
from .transition import TransitionBatch


class EpisodeBatch(NamedTuple):
    """A batch of trace windows; leading axes are ``[batch, time]``."""

    obs: torch.Tensor       # [B, T, *obs_shape]
    action: torch.Tensor    # [B, T] int64
    reward: torch.Tensor    # [B, T]
    next_obs: torch.Tensor  # [B, T, *obs_shape]
    done: torch.Tensor      # [B, T]
    mask: torch.Tensor      # [B, T] — 1 for valid steps


class EpisodeReplayState(NamedTuple):
    data: torch.Tensor       # [R + T - 1, E, F] obs_dtype: ring + shadows
    ep_start: torch.Tensor   # [E, M] int32 — global step of episode start
    ep_len: torch.Tensor     # [E, M] int32
    rec_count: torch.Tensor  # [E] int32 — records written per env
    cur_len: torch.Tensor    # [E] int32 — steps of the open episode
    t: torch.Tensor          # int64 scalar — global lockstep step counter


class EpisodeDraws(NamedTuple):
    """Injected draws of one sample of ``D`` windows (any may be None).

    ``env`` [D] env indices, or ``env_u`` [D] uniforms for the record
    mass ``u · total``; ``rec`` and ``start`` [D] raw non-negative ints,
    taken modulo the env's record count and the episode length."""

    env: Optional[torch.Tensor] = None
    env_u: Optional[torch.Tensor] = None
    rec: Optional[torch.Tensor] = None
    start: Optional[torch.Tensor] = None


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class EpisodeReplayBuffer:
    def __init__(self, obs_shape: Tuple[int, ...], max_size: int,
                 batch_size: int, trace_length: int, max_episode_length: int,
                 num_envs: int = 1, obs_dtype=torch.float32,
                 max_ring_bytes: int = 2 << 30, device=None):
        self.obs_shape = tuple(int(s) for s in obs_shape)
        self.max_size = int(max_size)
        self.batch_size = int(batch_size)
        self.trace_length = int(trace_length)
        self.max_episode_length = int(max_episode_length)
        self.num_envs = int(num_envs)
        self.obs_dtype = obs_dtype
        # f32 scalars bit-cast into 4*ratio ring lanes (16 B exact)
        self.ratio = storage_ratio(self.obs_dtype)
        self.device = resolve_device(device)
        self.no = 1
        for s in self.obs_shape:
            self.no *= s
        self.F = 2 * self.no + 4 * self.ratio
        # record slots per env, so that all envs hold >= max_size episodes
        self.records_per_env = max(2, -(-self.max_size // self.num_envs))
        # steps per env for max_size episodes, and at least two max-length
        # episodes so the open episode never overwrites its own start
        self.ring = _pow2(max(2 * self.max_episode_length,
                              self.records_per_env * self.max_episode_length))
        slot_bytes = self.F * (4 // self.ratio)
        min_ring = _pow2(2 * self.max_episode_length)
        while (self.ring > min_ring
               and self.num_envs * self.ring * slot_bytes > max_ring_bytes):
            self.ring //= 2
        total = self.num_envs * self.ring * slot_bytes
        if total > max_ring_bytes:
            raise ValueError(
                f"EpisodeReplayBuffer needs {total / 2**30:.2f} GiB even at "
                f"the minimum ring of 2*max_episode_length steps/env "
                f"({min_ring} slots x {self.num_envs} envs x {slot_bytes} B). "
                "Reduce num_envs, max_episode_length, or the observation "
                "size, or raise max_ring_bytes.")

    def init(self) -> EpisodeReplayState:
        E, R, M, T = (self.num_envs, self.ring, self.records_per_env,
                      self.trace_length)
        i32 = dict(dtype=torch.int32, device=self.device)
        return EpisodeReplayState(
            data=torch.zeros(R + T - 1, E, self.F, dtype=self.obs_dtype,
                             device=self.device),
            ep_start=torch.zeros(E, M, **i32), ep_len=torch.zeros(E, M, **i32),
            rec_count=torch.zeros(E, **i32), cur_len=torch.zeros(E, **i32),
            t=counter(0, self.device))

    def add_step(self, state: EpisodeReplayState, batch: TransitionBatch,
                 ended: torch.Tensor) -> EpisodeReplayState:
        """Append one transition per env (ring row ``t % R`` and its shadow
        row); envs whose episode ``ended`` commit a record. In place but
        for ``t``, which comes back advanced."""
        E, R, M, T = (self.num_envs, self.ring, self.records_per_env,
                      self.trace_length)
        k = (state.t % R).reshape(1)
        # the shadow of rows 0..T-2; from T-1 on, row k again (a duplicate
        # write in place of a branch)
        k2 = torch.where(k < T - 1, R + k, k)
        sc = pack_scalars((batch.action, batch.reward, batch.done,
                           torch.zeros_like(batch.reward, dtype=torch.float32)),
                          self.obs_dtype, self.ratio)
        row = torch.cat([
            batch.obs.reshape(E, self.no).to(self.obs_dtype),
            batch.next_obs.reshape(E, self.no).to(self.obs_dtype), sc], dim=1)
        state.data.index_copy_(0, k, row[None])
        state.data.index_copy_(0, k2, row[None])
        ended = ended.bool()
        new_len = state.cur_len + 1
        start = state.t.to(torch.int32) - new_len + 1
        # ended envs write record slot rec_count % M; the others match none
        slot = torch.where(ended, state.rec_count % M, M)
        sel = torch.arange(M, device=slot.device)[None, :] == slot[:, None]
        state.ep_start.copy_(torch.where(sel, start[:, None], state.ep_start))
        state.ep_len.copy_(torch.where(sel, new_len[:, None], state.ep_len))
        state.rec_count.add_(ended.to(torch.int32))
        state.cur_len.copy_(torch.where(ended, 0, new_len))
        return state._replace(t=state.t + 1)

    def reset_in_progress(self, state: EpisodeReplayState
                          ) -> EpisodeReplayState:
        """Drop the open episodes (after the populate phase, so that the
        training actor's fresh episodes do not extend them). In place."""
        state.cur_len.zero_()
        return state

    @property
    def size_fn(self):
        """``state -> `` the number of episode records the buffer holds (each
        env keeps at most ``records_per_env``), an int32 scalar."""
        return lambda state: torch.clamp(
            state.rec_count, max=self.records_per_env).sum(dtype=torch.int32)

    def sample(self, state: EpisodeReplayState,
               draws: Optional[EpisodeDraws] = None,
               generator: Optional[torch.Generator] = None) -> EpisodeBatch:
        return self._sample_batch(state, self.batch_size, draws, generator)

    def sample_n(self, state: EpisodeReplayState, n_batches: int,
                 draws: Optional[EpisodeDraws] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> EpisodeBatch:
        """``n_batches · batch_size`` windows in one gather, u-major: sub-batch
        ``u`` is rows ``[u·B, (u+1)·B)``."""
        return self._sample_batch(state, self.batch_size * n_batches, draws,
                                  generator)

    def _weighted_env(self, state: EpisodeReplayState, u: torch.Tensor):
        """Envs drawn in proportion to their stored episodes: the first env
        whose prefix sum of record counts exceeds the mass ``u · total``,
        one ``searchsorted`` over the f32 cumsum. The counts are integers,
        so every prefix is exact (below 2^24 records) and the env is the
        one the JAX package's count-tree descent finds. Once every env's
        record ring is full this is the uniform env draw, so there is no
        branch on the counts (which would read the device)."""
        counts = torch.clamp(state.rec_count, max=self.records_per_env)
        csum = torch.cumsum(counts.float(), dim=0)
        mass = u.float() * torch.clamp(csum[-1], min=1.0)
        env = torch.searchsorted(csum, mass, right=True)
        return torch.clamp(env, max=self.num_envs - 1)

    def _sample_batch(self, state: EpisodeReplayState, D: int,
                      draws: Optional[EpisodeDraws],
                      generator: Optional[torch.Generator]) -> EpisodeBatch:
        T, R, M = self.trace_length, self.ring, self.records_per_env
        dev = state.data.device
        d = draws if draws is not None else EpisodeDraws()
        raw = lambda x: (x if x is not None else torch.randint(
            0, 1 << 30, (D,), generator=generator, device=dev)).long()
        if d.env is not None:
            env = d.env.long()
        else:
            u = d.env_u if d.env_u is not None else torch.rand(
                D, generator=generator, device=dev)
            env = self._weighted_env(state, u)
        rec_count = state.rec_count[env].long()
        n_rec = torch.clamp(torch.clamp(rec_count, max=M), min=1)
        rec = raw(d.rec) % n_rec
        # remap records whose rows the ring has overwritten to the env's
        # newest record
        start = state.ep_start[env, rec].long()
        length = state.ep_len[env, rec].long()
        stale = (state.t - start) > (R - torch.clamp(length, min=1))
        rec = torch.where(stale, (rec_count - 1) % n_rec, rec)
        start = state.ep_start[env, rec].long()
        length = torch.clamp(state.ep_len[env, rec].long(), min=1)

        off = raw(d.start) % length
        steps = torch.arange(T, device=dev)
        valid = steps[None, :] < (length - off)[:, None]            # [D, T]
        mask = valid.float()
        rows = ((start + off) % R)[:, None] + steps[None, :]       # [D, T]
        win = state.data[rows, env[:, None]]                        # [D, T, F]
        no = self.no
        win = torch.where(valid[..., None], win,
                          torch.zeros((), dtype=win.dtype, device=dev))
        sc = unpack_scalars(win[..., 2 * no:], self.ratio)     # [D, T, 4] f32
        oshape = (D, T) + self.obs_shape
        return EpisodeBatch(
            obs=win[..., :no].reshape(oshape),
            action=sc[..., 0].long(),
            reward=sc[..., 1],
            next_obs=win[..., no:2 * no].reshape(oshape),
            done=sc[..., 2],
            mask=mask,
        )
