"""Start ``world`` gloo ranks of one program on this host.

:func:`spawn` runs ``fn(rank, world, *args)`` in ``world`` fresh processes
(the ``spawn`` start method, which CUDA ranks need), each with one torch
thread and joined to one gloo process group over a TCP rendezvous on a
free localhost port, and returns the ranks' return values. A rank that
raises or exits non-zero fails the whole call; nothing is retried. Gloo
reduces CPU tensors, and CUDA tensors through host memory, so it also runs
several ranks on one card, which NCCL refuses.
"""
from __future__ import annotations

import os
import queue as queue_mod
import socket
import time
import traceback

_TIMEOUT = 600.0  # seconds for every rank to return


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, local_world_size, fn, args, results):
    import torch
    import torch.distributed as dist

    from .multihost import initialize_multihost

    torch.set_num_threads(1)
    if local_world_size is not None:
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        results.put((rank, fn(rank, world, *args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, local_world_size=None):
    """Run ``fn(rank, world, *args)`` in ``world`` ranks (``fn`` and
    ``args`` must pickle); returns the list of return values by rank.
    ``local_world_size`` sets ``LOCAL_WORLD_SIZE`` in every rank (ranks per
    simulated host)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, local_world_size, fn, args, results))
        for r in range(world)]
    for p in procs:
        p.start()
    out, errors, got = [None] * world, [], 0
    deadline = time.monotonic() + _TIMEOUT
    try:
        while got < world and not errors:
            try:
                rank, value, err = results.get(timeout=0.5)
            except queue_mod.Empty:
                # a rank that dies before it reports (an import error, a
                # kill) fails the call now, not at the deadline
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks exited early: {dead}")
                elif time.monotonic() > deadline:
                    errors.append(f"no result from every rank within "
                                  f"{_TIMEOUT} s")
                continue
            got += 1
            out[rank] = value
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        if errors:
            for p in procs:
                p.kill()
        for p in procs:
            p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if errors or bad:
        raise RuntimeError(f"spawned ranks failed (exit codes {bad}):\n"
                           + "\n".join(errors))
    return out
