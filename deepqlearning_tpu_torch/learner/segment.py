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
  build, K3's and K5's grids and K2's level descriptors are cached, the
  cuBLAS and cuDNN handles and Adam's constants exist), puts the carry and
  its generator back as they were, captures one iteration, and copies the
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
  (``learner/loop.py::populate`` off the graph), an episode buffer's
  ``reset_in_progress`` after the ``n`` replays, as ``populate`` ends.
  :func:`collect_body` is that step as an iteration of the carry, which
  the data-parallel populate replays without that ending.
* :func:`graph_route`: the static gate of the routes this module captures:
  an env of the ``Env`` protocol, and a feed-forward network over a
  replay of ``replay/prioritized.py`` or a recurrent one (``recurrence``)
  over ``replay/episode.py``, in f32 or bf16; and either no ``axis_name``
  or one whose process groups are all NCCL. That takes every route of
  ``build_loop`` on the card: the feed-forward PER routes (K1-K4), DRQN
  with K5 and K6 or the plain recurrent steps, built-in and batched envs,
  envs and problems written one instance at a time, batched by
  ``torch.func.vmap`` (``envs/base.py``), and data parallelism over NCCL
  (K7, K8 and ``pmean_flat``'s all-reduces, captured into the graph;
  ``parallel/mesh.py``). The routes that run eagerly, by the same gate:
  CPU tensors, data parallelism over gloo (which reduces through host
  memory, outside any stream), and the host path ``solve_host``.
  ``solver/evaluation.py`` replays the greedy evaluation's step as a
  :class:`CompiledSegment` of its own.

There is no fallback: a capture that fails on a route of the gate raises,
naming the route, and nothing switches the graph off. Across ranks
(``group``), every rank captures the same collectives, and the capture's
and the guard replay's verdicts are all-reduced (MAX) before either
raises, so that every rank raises where one does instead of the others
hanging in their next collective.

The graph route's contract for user code: the env's methods (the batched
``reset_batch``, ``step_batch``, ``observe_batch``, or the per-instance
``reset``, ``step``, ``observe`` that vmap batches), an ``MDPEnv``/
``POMDPEnv`` problem of either form and a ``VectorizedStrategy``'s
function are captured once and replayed, so they must be pure device code:
no host read (``.item()``, ``bool(t)``, ``int(t)``, a data-dependent
shape), no pageable host-to-device copy, and nothing that changes on the
host between calls (a Python counter, a host random number, Python-side
state), which a replay would repeat as it was at capture. The first of
these makes the capture raise; for the others the segment runs one replay
right after the capture and requires it to equal the warm-up iteration bit
for bit (every carry tensor and the generator's state), and raises, naming
the route, where it does not.

Launch counts: the recorder's ``kernels.launches`` counts a launch where
Python calls the kernel library, so the warm-up and the capture count one
each and the replays none (they launch no Python). What a graph route
launches is the recorder's (``utils/profiling.py``) ``segment.replays`` times
``segment.graph_nodes`` for the route: the nodes of the captured
iteration, counted by type at every capture (``segment.graph_nodes.
kernel``, ...), with no profiler.

Spans and counters (``utils/profiling.py``), all outside the captured
code: ``segment.capture`` around a graph's making, with the children
``segment.warmup``, ``segment.graph`` (the capture and the node count)
and ``segment.guard``; ``segment.run`` and the counter
``segment.replays`` on each call, eager or replayed; ``populate`` around
:func:`make_collect_graph`'s run. Each takes the route as its attribute.
The counters ``segment.layer_calls.conv2d``, ``.maxpool2d``,
``.residual`` and ``.soft_moe`` of a route hold the forward calls of those
layers (``models/chain.py``) that one iteration makes, and
``.bias_act_kernel`` and ``.bias_act_plain`` the Conv2D, Dense and SoftMoE
forwards whose epilogue took K10 or the ATen chain: put at every capture from
the layers' own counters, as ``segment.graph_nodes`` is, and on an eager
route at every iteration.
A call of a :class:`CompiledSegment` now and then times its replays with
two CUDA events, one before the first and one after the last
(``profiling.ReplaySampler``).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten

from ..envs.base import Env
from ..ops.cuda.build import graph_nodes
from ..utils import profiling
from .loop import populate


def nccl_groups(axis_name) -> bool:
    """Whether ``axis_name`` (a process group or a tuple of them) is made
    of NCCL groups only: a collective over them runs on the card's
    streams, which a CUDA graph captures; gloo's runs on the host."""
    import torch.distributed as dist

    groups = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    return bool(groups) and all(
        isinstance(g, dist.ProcessGroup) and dist.get_backend(g) == "nccl"
        for g in groups)


def graph_route(cfg, env, buffer, axis_name=None) -> bool:
    """Whether the loop of ``cfg`` on ``env`` and ``buffer`` (with
    gradients averaged over ``axis_name``, if given) is one this module
    captures on the card (module docstring); the device is
    :func:`make_segment`'s to check."""
    from ..replay.episode import EpisodeReplayBuffer
    from ..replay.prioritized import PrioritizedReplayBuffer

    replay = EpisodeReplayBuffer if cfg.recurrence else \
        PrioritizedReplayBuffer
    return ((axis_name is None or nccl_groups(axis_name))
            and isinstance(env, Env) and isinstance(buffer, replay)
            and cfg.dtype in (torch.float32, torch.bfloat16))


def _check_leaves(leaves, what: str) -> None:
    host = sorted({type(x).__name__ for x in leaves
                   if not isinstance(x, (torch.Tensor, torch.Generator))})
    if host:
        raise TypeError(
            f"{what}: the carry holds host values ({', '.join(host)}); a "
            "graph replays device work only, so every counter must be a "
            "device tensor (build the carry with init_carry)")


# the layers that count their forward calls, and the two routes of the
# Conv2D, Dense and SoftMoE experts' epilogues (``models/chain.py``)
LAYER_CALLS = ("conv2d", "maxpool2d", "residual", "soft_moe",
               "bias_act_kernel", "bias_act_plain")


@contextlib.contextmanager
def layer_calls(route: str):
    """Put the counters ``segment.layer_calls.<layer>`` of ``route``: the
    forward calls of each layer of :data:`LAYER_CALLS` that the block
    made (none where it raised)."""
    before = [profiling.counter(f"model.{k}") for k in LAYER_CALLS]
    yield
    for k, b in zip(LAYER_CALLS, before):
        profiling.put(f"segment.layer_calls.{k}",
                      profiling.counter(f"model.{k}") - b, route)


def _agree(count: int, group, device) -> int:
    """``count``, or over ``group`` the largest of the ranks' counts."""
    if group is None:
        return count
    import torch.distributed as dist

    t = torch.tensor([count], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t)


class CompiledSegment:
    """One captured iteration over the static carry ``carry``; call it as
    ``run_segment(carry, n)`` (module docstring). ``route`` names the
    route in errors. ``group``: the process group whose ranks capture the
    same iteration (its collectives included) and must reach one verdict
    on the capture and on the guard replay; with a group the capture runs
    in ``torch.cuda.graph``'s ``"thread_local"`` mode, so that c10d's
    watchdog thread may query its events while this thread captures."""

    def __init__(self, iteration: Callable, carry, route: str, group=None):
        with profiling.span("segment.capture", route=route):
            self._capture(iteration, carry, route, group)

    def _capture(self, iteration, carry, route, group) -> None:
        self.route = route
        self.static = carry
        leaves, self._spec = tree_flatten(carry)
        _check_leaves(leaves, route)
        self._leaves = leaves
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        tensors = [x for x in leaves if torch.is_tensor(x)]
        device = tensors[0].device

        self._sampler = profiling.ReplaySampler(route, device)

        # warm-up on a side stream; its result is what one replay must give
        with profiling.span("segment.warmup", route=route):
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

        with profiling.span("segment.graph", route=route):
            # kept after capture so that its nodes can be counted, then
            # instantiated before the first replay
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            for g in gens:
                self.graph.register_generator_state(g)
            failed = None
            try:
                with layer_calls(route), torch.cuda.graph(
                        self.graph, capture_error_mode=(
                            "global" if group is None else "thread_local")):
                    self._copy_back(iteration(carry), "capture")
            except Exception as e:  # re-raised below, on every rank
                failed = e
            if _agree(failed is not None, group, device):
                where = device if failed is not None else "another rank"
                raise RuntimeError(
                    f"{route}: capturing one iteration as a CUDA graph "
                    f"failed on {where}; this route runs only as a graph (an "
                    "iteration must not read the device from the host: no "
                    ".item(), bool(t), int(t) or data-dependent shapes; a "
                    "collective must run on NCCL, without "
                    "TORCH_NCCL_BLOCKING_WAIT)") from failed
            nodes = graph_nodes(self.graph.raw_cuda_graph())
            self.graph.instantiate()
            profiling.put("segment.graph_nodes", sum(nodes.values()), route)
            for kind, k in nodes.items():
                profiling.put(f"segment.graph_nodes.{kind}", k, route)

        # the guard: host state that the capture froze shows as a replay
        # that differs from the eager iteration
        with profiling.span("segment.guard", route=route):
            self.graph.replay()
            differ = sum(not torch.equal(t, e)
                         for t, e in zip(tensors, expect))
            differ += sum(not torch.equal(g.get_state(), s)
                          for g, s in zip(gens, expect_states))
            self._restore(tensors, snapshot, gens, states)
            differ = _agree(differ, group, device)
        if differ:
            most = "" if group is None else " (on the rank where most differ)"
            raise RuntimeError(
                f"{route}: one replay of the captured iteration differs from "
                f"the eager iteration in {differ} of the carry's "
                f"{len(tensors) + len(gens)} tensors and generators{most}; a "
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

    def holds(self, carry) -> bool:
        """Whether ``carry``'s tensors are this graph's static buffers."""
        leaves = tree_flatten(carry)[0]
        return len(leaves) == len(self._leaves) and all(
            x is s for x, s in zip(leaves, self._leaves))

    def __call__(self, carry, n: int):
        if not self.holds(carry):
            raise ValueError(
                f"{self.route}: run_segment takes the carry it was made from "
                "(or one it returned): its tensors are the graph's buffers")
        n = int(n)
        with profiling.span("segment.run", route=self.route, n=n):
            profiling.count("segment.replays", n, self.route)
            ev = self._sampler.start(n)
            if ev:
                ev[0].record()
            for _ in range(n):
                self.graph.replay()
            if ev:
                ev[1].record()
        return self.static


def _eager_segment(iteration: Callable, route: str):
    """``run_segment(carry, n)``: ``n`` eager iterations, the same
    contract as :class:`CompiledSegment`'s."""

    def run_segment(carry, n: int):
        n = int(n)
        with profiling.span("segment.run", route=route, n=n):
            profiling.count("segment.replays", n, route)
            for _ in range(n):
                with layer_calls(route):
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
        return _eager_segment(iteration, route)
    return CompiledSegment(iteration, carry, route)


def collect_body(step: Callable) -> Callable:
    """One collect step of ``step`` (``populate_step``) on a carry's
    actor, replay and generator, as an iteration of the carry."""

    def body(c):
        actor, replay, params = step((c.actor, c.replay, c.params),
                                     c.generator)
        return c._replace(actor=actor, replay=replay, params=params)

    return body


def make_collect_graph(step: Callable, carry, cfg, env, buffer,
                       route: str = "populate"):
    """``run(carry, n) -> carry``: ``n`` collect steps of ``step`` (the
    ε = 1 ``populate_step`` of ``build_loop``) on the carry's actor,
    replay and generator, then an episode buffer's ``reset_in_progress``:
    ``populate`` of ``learner/loop.py``, as replays of one CUDA graph
    where :func:`make_segment` captures, else that function itself. On
    the graph route ``run`` returns once the replays' work is done on the
    card, so that the ``populate`` span holds it (the next graph's
    capture would wait for it anyway)."""
    graph = (CompiledSegment(collect_body(step), carry, route)
             if _graphed(carry, cfg, env, buffer) else None)

    def run(c, n: int):
        with profiling.span("populate", route=route, n=int(n)):
            if graph is None:
                return populate(step, buffer, c, n)
            # populate of no further step is populate's end alone: an
            # episode buffer drops its open episodes
            c = populate(step, buffer, graph(c, n), 0)
            torch.cuda.synchronize(c.generator.device)
            return c

    return run
