"""The system under test: the port's actor-learner loop, built as
``DeepQLearningSolver.solve`` builds it, and read back for the check.

``build`` makes the env and the dueling network from the files of their
kinds (``envs/<kind>.py``, ``layers/<kind>.py``), the PER buffer and the
``DQNConfig`` from a configuration and a cell's traffic, then
``build_loop``, ``init_carry`` (every parameter and env state drawn from
the seed), the populate graph (``make_collect_graph``) run up to the
replay start, and the segment (``make_segment``): ``run_segment(carry,
n)`` replays the iteration's CUDA graph ``n`` times on the card.

The ``snapshot_*`` functions copy the loop's state to the host for the
plain reference: the start of the checked iterations, the rows each one
inserted and the priorities it left, Adam's first moment after the first
and the parameters after the last (``checked``). They read the
program's state only; nothing here computes.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

def _net(spec, parts, device):
    """The port's network: its layers from their kinds' files
    (``layers/<kind>.py``), split by ``create_dueling_network``."""
    from deepqlearning_tpu_torch import Chain, create_dueling_network

    return create_dueling_network(Chain(*[
        parts.layer(layer[0]).program(list(layer[1:]), device)
        for layer in spec["layers"]]))


def build(config: dict, tr: dict, seed: int, device, parts, wrap=None):
    """The loop after populate, as a namespace: ``run_segment``, ``carry``,
    ``cfg``, ``buffer`` (and the populate graph, ``fill``, held as
    ``solve`` holds it). ``parts`` (the registry) finds the env's and the
    layers' files; ``wrap(iteration) -> iteration`` lets a test break the
    timed path underneath."""
    from deepqlearning_tpu_torch import (
        DQNConfig, LinearDecaySchedule, PrioritizedReplayBuffer)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    from deepqlearning_tpu_torch.learner.segment import (
        make_collect_graph, make_segment)

    env = parts.env(config["env"]["kind"]).program(config["env"])
    net = _net(config["net"], parts, device)
    per = config["per"]
    cfg = DQNConfig(
        num_envs=tr["num_envs"], batch_size=tr["batch_size"],
        buffer_size=tr["buffer_size"], train_freq=tr["train_freq"],
        learning_rate=config["learning_rate"],
        target_update_freq=tr["target_update_freq"],
        train_start=tr["train_start"],
        max_episode_length=config["max_episode_length"],
        double_q=config["double_q"], dueling=True, prioritized_replay=True,
        prioritized_replay_alpha=per["alpha"],
        prioritized_replay_beta=per["beta"],
        prioritized_replay_epsilon=per["eps"], seed=int(seed),
        dtype=getattr(torch, config["dtype"]), logdir=None)
    buf = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size, alpha=per["alpha"],
        beta=per["beta"], eps=per["eps"], prioritized=True,
        obs_dtype=cfg.dtype, device=device)
    ex = config["exploration"]
    it, pop, opt = build_loop(
        env, net, buf, cfg, LinearDecaySchedule(ex["start"], ex["stop"],
                                                ex["steps"]),
        gamma=env.discount)
    if wrap is not None:
        it = wrap(it)
    carry = init_carry(env, net, buf, cfg, opt, device)
    fill = make_collect_graph(pop, carry, cfg, env, buf, "port_bench populate")
    carry = fill(carry, tr["populate_steps"])
    run = make_segment(it, carry, cfg, env, buf, "port_bench segment")
    return SimpleNamespace(run_segment=run, carry=carry, cfg=cfg, buffer=buf,
                           fill=fill)


def _host(x):
    return x.detach().to("cpu", copy=True)


def _split_rows(rows, buf):
    """The program's storage rows as ``(obs, next_obs, scalars [., 4]
    f32)`` on the host (its documented layout: obs, next_obs, then the
    four f32 scalars bit-cast into the storage lanes)."""
    no = buf.no
    rows = _host(rows)  # one contiguous copy, split on the host
    sc = rows[:, 2 * no:].contiguous()
    sc = sc.view(torch.float32) if buf.ratio > 1 else sc.float()
    return rows[:, :no], rows[:, no:2 * no], sc


def snapshot_start(p) -> dict:
    """The loop's state before the first checked iteration."""
    c, rep = p.carry, p.carry.replay
    size = int(rep.size)
    o, no, sc = _split_rows(rep.rows[:size], p.buffer)
    return dict(
        params={k: _host(v) for k, v in c.params.items()},
        target={k: _host(v) for k, v in c.target_params.items()},
        env_state=_host(c.actor.env_state), obs=_host(c.actor.obs),
        ep_step=_host(c.actor.ep_step), t=int(c.actor.t),
        sync_acc=int(c.sync_acc), rows_obs=o, rows_next_obs=no,
        rows_scalars=sc, tree=[_host(x) for x in rep.tree],
        pos=int(rep.insert_pos), size=size,
        gen_state=c.generator.get_state())


def snapshot_rows(p, pos: int) -> dict:
    """The rows one iteration inserted at ``pos`` (one per env) and the
    priorities it left."""
    E, C = p.cfg.num_envs, p.cfg.buffer_size
    idx = (pos + torch.arange(E, device=p.carry.replay.rows.device)) % C
    o, no, sc = _split_rows(p.carry.replay.rows[idx], p.buffer)
    return dict(obs=o, next_obs=no, scalars=sc, action=sc[:, 0],
                tree=[_host(x) for x in p.carry.replay.tree])


def snapshot_end(p) -> dict:
    c = p.carry
    return dict(params={k: _host(v) for k, v in c.params.items()},
                target={k: _host(v) for k, v in c.target_params.items()})


def checked(p, n: int):
    """Run the loop's first ``n`` iterations through its own call,
    ``run_segment(carry, 1)``, and copy what the reference needs to the
    host: ``(start, readings, rows, held)``: the state before them, the
    loop's readings (each iteration's loss, Adam's first moment after the
    first, the parameters after the last), each iteration's rows and
    priorities, and the seconds the copies took (the check's, not the
    program's)."""
    import time

    t = time.perf_counter()
    start = snapshot_start(p)
    held = time.perf_counter() - t
    prog, rows = {"loss": []}, []
    for k in range(n):
        pos = int(p.carry.replay.insert_pos)
        p.carry = p.run_segment(p.carry, 1)
        prog["loss"].append(float(p.carry.loss))
        t = time.perf_counter()
        rows.append(snapshot_rows(p, pos))
        if k == 0:
            prog["m1"] = {name: _host(v)
                          for name, v in p.carry.opt_state.m.items()}
        held += time.perf_counter() - t
    t = time.perf_counter()
    prog.update(snapshot_end(p))
    return start, prog, rows, held + time.perf_counter() - t
