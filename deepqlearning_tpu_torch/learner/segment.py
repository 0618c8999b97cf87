"""The compiled segment: one CUDA graph per iteration, replayed.

Counterpart of the JAX solver's ``run_segment = jax.jit(lambda c, n:
lax.scan(iteration, c, None, length=n))`` and of its jitted ``populate``
(``deepqlearning_tpu/solver/solver.py``). XLA compiles the iteration into
one device program; on the card its counterpart is a CUDA graph of one
iteration, captured once over static carry buffers and replayed ``n``
times, so a segment costs the host one graph launch per iteration instead
of every op's enqueue. It needs what the JAX package has: every counter of
the carry on the device and no host read inside an iteration
(``learner/loop.py``).

* :func:`make_segment` ``(iteration, carry, cfg, env, buffer) ->
  run_segment(carry, n)``: on a route of :func:`graph_route` with the
  carry on the card, warms one iteration up on a side stream (the kernels
  build, K3's grid and K2's level descriptors are cached, the cuBLAS and
  cuDNN handles and Adam's constants exist), puts the carry and its
  generator back as they were, captures one iteration, and copies the
  iteration's new tensors (the env state, obs, episode counters, loss, the
  counters) back into the static carry at the end of the captured
  iteration. The carry's ``torch.Generator`` is registered with the graph,
  so every replay draws fresh numbers at the offset eager iterations would
  use, and ``get_state()`` after ``n`` replays equals the state after
  ``n`` eager iterations. Elsewhere (CPU tensors, which is what the caller
  asked for, or a route off the gate) ``run_segment`` runs ``n`` eager
  iterations.
* :func:`make_collect_graph` ``(step, carry, cfg, env, buffer) ->
  run(carry, n)``: the same for ``populate``'s ε = 1 collect step
  (``learner/loop.py::populate`` off the graph).
* :func:`graph_route`: the static gate of the routes this module captures:
  a feed-forward network (no ``recurrence``), no ``axis_name``, a replay
  of ``replay/prioritized.py``, an env whose batched methods are its
  class's own (not a per-instance env batched by ``torch.func.vmap``), in
  f32 or bf16. The DRQN routes (K5, K6 over the episode replay), data
  parallelism (K7, K8 and the collectives), the per-instance envs and the
  host path ``solve_host`` run eagerly.

There is no fallback: a capture that fails on a route of the gate raises,
naming the route, and nothing switches the graph off.

The graph route's contract for user code: the env's batched methods
(``reset_batch``, ``step_batch``, ``observe_batch``), a batched
``MDPEnv``/``POMDPEnv`` problem and a ``VectorizedStrategy``'s function are
captured once and replayed, so they must be pure device code: no host read
(``.item()``, ``bool(t)``, ``int(t)``, a data-dependent shape), no
pageable host-to-device copy, and nothing that changes on the host between
calls (a Python counter, a host random number, Python-side state), which a
replay would repeat as it was at capture. The first of these makes the
capture raise; for the others the segment runs one replay right after the
capture and requires it to equal the warm-up iteration bit for bit (every
carry tensor and the generator's state), and raises, naming the route,
where it does not.

Launch counts: a kernel wrapper counts a launch where Python calls it, so
the warm-up and the capture count one each and the replays none (they
launch no Python); what the replays launch is read from a
``torch.profiler`` trace of them (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten

from ..envs.base import Env
from .loop import populate


def graph_route(cfg, env, buffer, axis_name=None) -> bool:
    """Whether the loop of ``cfg`` on ``env`` and ``buffer`` is one this
    module captures on the card (module docstring); the device is
    :func:`make_segment`'s to check."""
    from ..replay.prioritized import PrioritizedReplayBuffer

    own = all(getattr(type(env), m) is not getattr(Env, m)
              for m in ("reset_batch", "step_batch"))
    return (not cfg.recurrence and axis_name is None
            and isinstance(buffer, PrioritizedReplayBuffer)
            and own and getattr(env, "batched", True)
            and cfg.dtype in (torch.float32, torch.bfloat16))


def _check_leaves(leaves, what: str) -> None:
    host = sorted({type(x).__name__ for x in leaves
                   if not isinstance(x, (torch.Tensor, torch.Generator))})
    if host:
        raise TypeError(
            f"{what}: the carry holds host values ({', '.join(host)}); a "
            "graph replays device work only, so every counter must be a "
            "device tensor (build the carry with init_carry)")


class CompiledSegment:
    """One captured iteration over the static carry ``carry``; call it as
    ``run_segment(carry, n)`` (module docstring). ``route`` names the
    route in errors."""

    def __init__(self, iteration: Callable, carry, route: str):
        self.route = route
        self.static = carry
        leaves, self._spec = tree_flatten(carry)
        _check_leaves(leaves, route)
        self._leaves = leaves
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        tensors = [x for x in leaves if torch.is_tensor(x)]
        device = tensors[0].device

        # warm-up on a side stream; its result is what one replay must give
        snapshot = [t.clone() for t in tensors]
        states = [g.get_state() for g in gens]
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._copy_back(iteration(carry), "warm-up")
        main.wait_stream(side)
        expect = [t.clone() for t in tensors]
        expect_states = [g.get_state() for g in gens]
        self._restore(tensors, snapshot, gens, states)

        self.graph = torch.cuda.CUDAGraph()
        for g in gens:
            self.graph.register_generator_state(g)
        try:
            with torch.cuda.graph(self.graph):
                self._copy_back(iteration(carry), "capture")
        except Exception as e:
            raise RuntimeError(
                f"{route}: capturing one iteration as a CUDA graph failed "
                f"on {device}; this route runs only as a graph (an "
                "iteration must not read the device from the host: no "
                ".item(), bool(t), int(t) or data-dependent shapes)") from e

        # the guard: host state that the capture froze shows as a replay
        # that differs from the eager iteration
        self.graph.replay()
        differ = sum(not torch.equal(t, e) for t, e in zip(tensors, expect))
        differ += sum(not torch.equal(g.get_state(), s)
                      for g, s in zip(gens, expect_states))
        self._restore(tensors, snapshot, gens, states)
        if differ:
            raise RuntimeError(
                f"{route}: one replay of the captured iteration differs from "
                f"the eager iteration in {differ} of the carry's "
                f"{len(tensors) + len(gens)} tensors and generators; a "
                "replay repeats the iteration as it was at capture, so the "
                "env's batched methods, the problem and the exploration "
                "function must be pure device code (no Python counter, "
                "host random number or other host-side state)")

    @staticmethod
    def _restore(tensors, snapshot, gens, states) -> None:
        for t, s in zip(tensors, snapshot):
            t.copy_(s)
        for g, s in zip(gens, states):
            g.set_state(s)

    def _copy_back(self, out, when: str) -> None:
        """Copy the iteration's new tensors into the static carry (those it
        updated in place are already there)."""
        leaves, spec = tree_flatten(out)
        if spec != self._spec:
            raise TypeError(f"{self.route}: the iteration returned a carry "
                            f"of another structure ({when})")
        _check_leaves(leaves, self.route)
        pairs = [(s, o) for s, o in zip(self._leaves, leaves)
                 if torch.is_tensor(o) and o is not s]
        for s, o in pairs:
            if s.shape != o.shape or s.dtype != o.dtype:
                raise TypeError(
                    f"{self.route}: a carry tensor of {tuple(s.shape)} "
                    f"{s.dtype} came back as {tuple(o.shape)} {o.dtype}")
        # a new tensor that shares memory with a static one is read before
        # any static tensor is written
        dst = {s.untyped_storage().data_ptr() for s, _ in pairs}
        pairs = [(s, o.clone() if o.untyped_storage().data_ptr() in dst
                  else o) for s, o in pairs]
        # the scalars (counters, loss) in one multi-tensor copy per dtype,
        # the per-env tensors each by its own copy (a multi-tensor copy of
        # a few large tensors is the slower on the card)
        groups = {}
        for s, o in pairs:
            if s.dim():
                s.copy_(o)
            else:
                groups.setdefault(s.dtype, []).append((s, o))
        for group in groups.values():
            torch._foreach_copy_([s for s, _ in group],
                                 [o for _, o in group])

    def __call__(self, carry, n: int):
        leaves = tree_flatten(carry)[0]
        if len(leaves) != len(self._leaves) or any(
                x is not s for x, s in zip(leaves, self._leaves)):
            raise ValueError(
                f"{self.route}: run_segment takes the carry it was made from "
                "(or one it returned): its tensors are the graph's buffers")
        for _ in range(int(n)):
            self.graph.replay()
        return self.static


def _eager_segment(iteration: Callable):
    """``run_segment(carry, n)``: ``n`` eager iterations, the same
    contract as :class:`CompiledSegment`'s."""

    def run_segment(carry, n: int):
        for _ in range(int(n)):
            carry = iteration(carry)
        return carry

    return run_segment


def _graphed(carry, cfg, env, buffer) -> bool:
    return (carry.generator.device.type == "cuda"
            and graph_route(cfg, env, buffer))


def make_segment(iteration: Callable, carry, cfg, env, buffer,
                 route: str = "segment"):
    """``run_segment(carry, n) -> carry``: ``n`` iterations of the loop of
    ``cfg`` on ``env`` and ``buffer`` (``build_loop``'s), as replays of one
    CUDA graph when the carry is on the card and the route is one of
    :func:`graph_route`'s, else eagerly (module docstring). Build it from
    the carry the segments will run on: it is the graph's static carry,
    and ``run_segment`` returns it."""
    if not _graphed(carry, cfg, env, buffer):
        return _eager_segment(iteration)
    return CompiledSegment(iteration, carry, route)


def make_collect_graph(step: Callable, carry, cfg, env, buffer,
                       route: str = "populate"):
    """``run(carry, n) -> carry``: ``n`` collect steps of ``step`` (the
    ε = 1 ``populate_step`` of ``build_loop``) on the carry's actor,
    replay and generator: ``populate`` of ``learner/loop.py``, as replays
    of one CUDA graph where :func:`make_segment` captures, else that
    function itself."""
    if not _graphed(carry, cfg, env, buffer):
        return lambda c, n: populate(step, buffer, c, n)

    def body(c):
        actor, replay, params = step((c.actor, c.replay, c.params),
                                     c.generator)
        return c._replace(actor=actor, replay=replay, params=params)

    return CompiledSegment(body, carry, route)
