"""Prioritized (and uniform) experience replay on the device.

Counterpart of ``deepqlearning_tpu.replay.prioritized``:

* one merged row per slot in the storage dtype ``obs_dtype`` (any 1-, 2-
  or 4-byte dtype), ``[C, 2·no + 4·ratio]`` with ``ratio = 4 /
  itemsize``: obs and next_obs cast to the storage dtype (``astype``:
  uint8 truncates), then the four f32 scalars (action, reward, done, pad)
  bit-cast into ``4·ratio`` lanes (``Tensor.view``, the lane order of
  ``jax.lax.bitcast_convert_type``), so they round-trip exactly; f32 is
  the identity case, ``[C, 2·no + 4]``;
* a sample returns obs in the storage dtype (no upcast: the network
  promotes as it needs);
* priority at insert ``(|r| + eps)^alpha``, at update ``(|td| + eps)^alpha``;
* IS weights ``(N·p/total)^(-beta)``, not max-normalized, with the
  empty-buffer clamp to unit weight;
* uniform replay = constant priorities, no updates, unit weights;
* ``sample_mode="without_replacement"``: the reference's draw without
  replacement within a sub-batch (Gumbel-top-k over the leaves, one
  independent pass per sub-batch, ``ops/sumtree.py``), bypassing the
  stratified descent and kernel K2, as the JAX package bypasses its Pallas
  sampler; a draw that lands on an unfilled slot gets IS weight 0.

The rows and the sum-tree levels are updated IN PLACE; ``insert`` and
``update_priorities`` return a ``ReplayState`` over the same tensors, with
the insert position and fill size as Python ints (they advance by a fixed
batch size, so the host knows them without reading the device).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops import sumtree
from .transition import TransitionBatch


def storage_ratio(obs_dtype) -> int:
    """Storage lanes per f32 scalar (``4 / itemsize``) of a 1-, 2- or
    4-byte dtype; ``ValueError`` for any other, as the JAX buffers."""
    size = torch.empty((), dtype=obs_dtype).element_size()
    if size not in (1, 2, 4):
        raise ValueError(
            f"obs_dtype must be a 1/2/4-byte dtype, got {obs_dtype}")
    return 4 // size


def pack_scalars(cols, dtype, ratio: int) -> torch.Tensor:
    """The f32 scalar columns ``cols`` as storage lanes ``[E, len·ratio]``:
    bit-cast for a narrow dtype, a plain cast at ratio 1."""
    sc = torch.stack([c.float() for c in cols], dim=1)
    return sc.view(dtype) if ratio > 1 else sc.to(dtype)


def unpack_scalars(sc: torch.Tensor, ratio: int) -> torch.Tensor:
    """Storage lanes ``[..., 4·ratio]`` -> the four f32 scalars ``[...,
    4]``, exactly."""
    return sc.contiguous().view(torch.float32) if ratio > 1 else sc.float()


class ReplayState(NamedTuple):
    rows: torch.Tensor     # [C, 2*no + 4*ratio] obs_dtype
    tree: tuple            # per-level sum-tree tensors (leaves = cap2 >= C)
    insert_pos: int
    size: int


class PrioritizedReplayBuffer:
    """Static descriptor + ops for a PER buffer on ``device`` (``None``:
    ``cuda``, raising without CUDA; the CPU only when asked for)."""

    def __init__(self, obs_shape: Tuple[int, ...], max_size: int,
                 batch_size: int, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-3, prioritized: bool = True,
                 obs_dtype=torch.float32, sample_mode: str = "stratified",
                 device=None):
        self.obs_shape = tuple(int(s) for s in obs_shape)
        self.no = 1
        for s in self.obs_shape:
            self.no *= s
        self.max_size = int(max_size)
        self.batch_size = int(batch_size)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self.prioritized = bool(prioritized)
        self.obs_dtype = obs_dtype
        # f32 scalars bit-cast into 4*ratio storage lanes (16 B exact)
        self.ratio = storage_ratio(self.obs_dtype)
        if sample_mode not in ("stratified", "without_replacement"):
            raise ValueError(
                f"sample_mode must be 'stratified' or 'without_replacement', "
                f"got {sample_mode!r}")
        if sample_mode == "without_replacement" and \
                self.batch_size > self.max_size:
            # each pass draws batch_size distinct leaves
            raise ValueError(
                f"without_replacement sampling needs batch_size "
                f"({self.batch_size}) <= buffer max_size ({self.max_size})")
        self.sample_mode = sample_mode
        self.device = resolve_device(device)

    def init(self) -> ReplayState:
        return ReplayState(
            rows=torch.zeros(self.max_size, 2 * self.no + 4 * self.ratio,
                             dtype=self.obs_dtype, device=self.device),
            tree=sumtree.init_tree(self.max_size, self.device),
            insert_pos=0, size=0,
        )

    def _pack(self, batch: TransitionBatch) -> torch.Tensor:
        """A transition batch as storage rows (see the module docstring)."""
        E = batch.action.shape[0]
        sc = pack_scalars((batch.action, batch.reward, batch.done,
                           torch.zeros_like(batch.reward, dtype=torch.float32)),
                          self.obs_dtype, self.ratio)
        return torch.cat([
            batch.obs.reshape(E, self.no).to(self.obs_dtype),
            batch.next_obs.reshape(E, self.no).to(self.obs_dtype), sc], dim=1)

    def peek_scalars(self, state: ReplayState) -> torch.Tensor:
        """Every slot's (action, reward, done, pad) as ``[C, 4]`` f32 — a
        test and diagnostic helper."""
        return unpack_scalars(state.rows[:, 2 * self.no:], self.ratio)

    def _initial_priority(self, reward: torch.Tensor) -> torch.Tensor:
        if self.prioritized:
            return (reward.abs() + self.eps) ** self.alpha
        return torch.full_like(reward, self.eps ** self.alpha)

    def insert(self, state: ReplayState, batch: TransitionBatch
               ) -> ReplayState:
        """Ring-insert E transitions, in place. When E divides the capacity
        the write is one contiguous slice; otherwise a scatter with
        wraparound."""
        E = batch.action.shape[0]
        prio = self._initial_priority(batch.reward.float())
        rows = self._pack(batch)
        pos = state.insert_pos
        if self.max_size % E == 0:
            state.rows[pos:pos + E] = rows
            sumtree.set_priorities_slice(state.tree, pos, prio)
        else:
            idx = (pos + torch.arange(E, device=rows.device)) % self.max_size
            state.rows[idx] = rows[sumtree.last_source(idx, self.max_size)]
            sumtree.set_priorities(state.tree, idx, prio)
        return ReplayState(state.rows, state.tree,
                           (pos + E) % self.max_size,
                           min(state.size + E, self.max_size))

    def sample(self, state: ReplayState, u=None, generator=None):
        return self.sample_n(state, 1, u=u, generator=generator)

    def sample_n(self, state: ReplayState, n_batches: int,
                 u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """Draw ``n_batches * batch_size`` transitions in one stratified
        descent (kernel K2, ``ops/cuda/tree_sample.py``). ``u`` are the raw
        uniforms ``[n*B]`` (drawn from ``generator`` if not given). Without
        replacement, a Gumbel-top-k pass per sub-batch instead (one top-k
        over ``[n, leaves]``), ``u`` the Gumbel noise ``[n, leaves]``.

        The flat outputs are u-major: sub-batch ``u`` occupies rows
        ``[u*B, (u+1)*B)`` and takes strata ``{u, n+u, 2n+u, ...}``.
        Obs keep the storage dtype. Returns ``(TransitionBatch, indices
        [nB] int64, weights [nB])``."""
        B = self.batch_size
        D = B * n_batches
        wor = self.sample_mode == "without_replacement"
        if wor:
            noise = (sumtree.gumbel((n_batches, state.tree[0].shape[0]),
                                    generator, state.rows.device)
                     if u is None else u.reshape(n_batches, -1))
            idx, prio = sumtree.sample_without_replacement(state.tree, B,
                                                           noise)
            idx, prio = idx.reshape(D), prio.reshape(D)
        else:
            from ..ops.cuda.tree_sample import tree_sample

            if u is None:
                u = torch.rand(D, generator=generator,
                               device=state.rows.device)
            mass = sumtree.stratified_mass(state.tree, u)
            idx, prio = tree_sample(state.tree, mass, n_batches)
        rows = state.rows[idx]
        sc = unpack_scalars(rows[:, 2 * self.no:], self.ratio)  # [D, 4] f32
        oshape = (D,) + self.obs_shape
        batch = TransitionBatch(
            obs=rows[:, :self.no].reshape(oshape),
            action=sc[:, 0].long(),
            reward=sc[:, 1],
            next_obs=rows[:, self.no:2 * self.no].reshape(oshape),
            done=sc[:, 2],
        )
        if self.prioritized:
            p = prio / torch.clamp(sumtree.total(state.tree), min=1e-30)
            n = float(max(state.size, 1))
            # a stratified draw lands on a zero leaf only in an empty
            # buffer (unit weight: finite); a pass without replacement
            # hands out unfilled slots once the filled ones run out, and
            # those must not train (weight 0)
            weights = torch.where(p > 0, (n * p) ** (-self.beta),
                                  torch.full_like(p, 0.0 if wor else 1.0))
        else:
            weights = torch.ones(D, dtype=torch.float32, device=idx.device)
        return batch, idx, weights

    def update_priorities(self, state: ReplayState, indices: torch.Tensor,
                          td_errors: torch.Tensor,
                          priorities: Optional[torch.Tensor] = None
                          ) -> ReplayState:
        """Set ``(|td| + eps)^alpha`` (or the given ``priorities``) at
        ``indices``, in place; a leaf drawn twice keeps its last value."""
        if not self.prioritized:
            return state
        if priorities is None:
            priorities = (td_errors.abs() + self.eps) ** self.alpha
        sumtree.set_priorities(state.tree, indices, priorities)
        return state


def ReplayBuffer(obs_shape, max_size, batch_size, obs_dtype=torch.float32,
                 device=None):
    """Uniform replay buffer: PER with constant priorities."""
    return PrioritizedReplayBuffer(obs_shape, max_size, batch_size,
                                   prioritized=False, obs_dtype=obs_dtype,
                                   device=device)
