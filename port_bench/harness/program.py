"""The system under test: the port's actor-learner loop, built as
``DeepQLearningSolver.solve`` builds it, and read back for the check.

``build`` makes the env and the dueling network from the files of their
kinds (``envs/<kind>.py``, ``layers/<kind>.py``), the replay and the
``DQNConfig`` from a configuration and a cell's traffic, then
``build_loop``, ``init_carry`` (every parameter and env state drawn from
the seed), the populate graph (``make_collect_graph``) run up to the
replay start, and the segment (``make_segment``): ``run_segment(carry,
n)`` replays the iteration's CUDA graph ``n`` times on the card. The
replay is the PER buffer, or with ``recurrence`` in the configuration the
episode replay of DRQN (``EpisodeReplayBuffer``, trace windows of
``trace_length`` steps, ``buffer_size`` episodes), populated for at least
``max_episode_length + 1`` steps and then cut of its open episodes, as
``solve`` does (``make_collect_graph`` ends so).

The snapshots copy the loop's state to the host for the plain reference:
the start of the checked iterations, what each one inserted (the rows and
the priorities it left: ``PER``; the ring row, the episode records and
the actor's recurrent state: ``EPISODES``), Adam's first moment after the
first and the parameters after the last (``checked``). They read the
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
    ``cfg``, ``buffer``, the snapshots of its replay (``route``: ``PER`` or
    ``EPISODES``) and the populate graph, ``fill``, held as ``solve``
    holds it. ``parts`` (the registry) finds the env's and the
    layers' files; ``wrap(iteration) -> iteration`` lets a test break the
    timed path underneath."""
    from deepqlearning_tpu_torch import (
        DQNConfig, EpisodeReplayBuffer, LinearDecaySchedule,
        PrioritizedReplayBuffer)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    from deepqlearning_tpu_torch.learner.segment import (
        make_collect_graph, make_segment)

    env = parts.env(config["env"]["kind"]).program(config["env"])
    net = _net(config["net"], parts, device)
    common = dict(
        num_envs=tr["num_envs"], batch_size=tr["batch_size"],
        buffer_size=tr["buffer_size"], train_freq=tr["train_freq"],
        learning_rate=config["learning_rate"],
        target_update_freq=tr["target_update_freq"],
        train_start=tr["train_start"],
        max_episode_length=config["max_episode_length"],
        double_q=config["double_q"], dueling=True, seed=int(seed),
        dtype=getattr(torch, config["dtype"]), logdir=None)
    if "recurrence" in config:
        cfg = DQNConfig(recurrence=True, trace_length=tr["trace_length"],
                        prioritized_replay=False, **common)
        buf = EpisodeReplayBuffer(
            env.obs_shape, cfg.buffer_size, cfg.batch_size,
            cfg.trace_length, cfg.max_episode_length,
            num_envs=cfg.num_envs, obs_dtype=cfg.dtype, device=device)
        route = EPISODES
    else:
        per = config["per"]
        cfg = DQNConfig(prioritized_replay=True,
                        prioritized_replay_alpha=per["alpha"],
                        prioritized_replay_beta=per["beta"],
                        prioritized_replay_epsilon=per["eps"], **common)
        buf = PrioritizedReplayBuffer(
            env.obs_shape, cfg.buffer_size, cfg.batch_size,
            alpha=per["alpha"], beta=per["beta"], eps=per["eps"],
            prioritized=True, obs_dtype=cfg.dtype, device=device)
        route = PER
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
                           fill=fill, route=route)


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


def _params(c) -> dict:
    return dict(params={k: _host(v) for k, v in c.params.items()},
                target={k: _host(v) for k, v in c.target_params.items()})


def _actor(c) -> dict:
    return dict(env_state=_host(c.actor.env_state), obs=_host(c.actor.obs),
                ep_step=_host(c.actor.ep_step), t=int(c.actor.t),
                sync_acc=int(c.sync_acc), gen_state=c.generator.get_state())


def _per_start(p) -> dict:
    """The loop's state before the first checked iteration."""
    c, rep = p.carry, p.carry.replay
    size = int(rep.size)
    o, no, sc = _split_rows(rep.rows[:size], p.buffer)
    return dict(_params(c), **_actor(c), rows_obs=o, rows_next_obs=no,
                rows_scalars=sc, tree=[_host(x) for x in rep.tree],
                pos=int(rep.insert_pos), size=size)


def _per_rows(p, pos: int) -> dict:
    """The rows one iteration inserted at ``pos`` (one per env) and the
    priorities it left."""
    E, C = p.cfg.num_envs, p.cfg.buffer_size
    idx = (pos + torch.arange(E, device=p.carry.replay.rows.device)) % C
    o, no, sc = _split_rows(p.carry.replay.rows[idx], p.buffer)
    return dict(obs=o, next_obs=no, scalars=sc, action=sc[:, 0],
                tree=[_host(x) for x in p.carry.replay.tree])


def _hidden(c):
    """The actor's recurrent state, every tensor of it side by side ``[E,
    .]`` (an LSTM's ``h`` then ``c``)."""
    return _host(torch.cat([x for s in c.actor.net_state for x in s],
                           dim=1))


def _records(rep) -> dict:
    return dict(ep_start=_host(rep.ep_start), ep_len=_host(rep.ep_len),
                rec_count=_host(rep.rec_count), cur_len=_host(rep.cur_len))


def _episode_start(p) -> dict:
    """The loop's state before the first checked iteration: the ring's
    ``R`` rows (without the mirrored rows after it) as ``[R, E, .]``."""
    c, rep = p.carry, p.carry.replay
    R, E = p.buffer.ring, p.cfg.num_envs
    o, no, sc = _split_rows(rep.data[:R].reshape(R * E, -1), p.buffer)
    ring = [x.reshape(R, E, -1) for x in (o, no, sc)]
    return dict(_params(c), **_actor(c), **_records(rep),
                ring_obs=ring[0], ring_next_obs=ring[1],
                ring_scalars=ring[2], ring_t=int(rep.t), hidden=_hidden(c))


def _episode_rows(p, t: int) -> dict:
    """The ring row that the iteration at step ``t`` wrote (one per env),
    the episode records and the actor's recurrent state after it."""
    rep = p.carry.replay
    o, no, sc = _split_rows(rep.data[t % p.buffer.ring], p.buffer)
    return dict(obs=o, next_obs=no, scalars=sc, action=sc[:, 0],
                hidden=_hidden(p.carry), **_records(rep))


# what ``checked`` reads of each replay: the start, the mark an iteration
# writes at (the PER insert position, the episode ring's step) and what
# that iteration inserted
PER = SimpleNamespace(start=_per_start,
                      mark=lambda p: int(p.carry.replay.insert_pos),
                      rows=_per_rows)
EPISODES = SimpleNamespace(start=_episode_start,
                           mark=lambda p: int(p.carry.replay.t),
                           rows=_episode_rows)


def adam_counters() -> dict:
    """The recorder's count of plain-step Adam calls that launched K9
    (``train.adam_kernel``) or ran its CPU twin (``train.adam_plain``):
    both nought on a route whose update kernel holds Adam (K3, K5)."""
    from . import recorder

    counters = (recorder.snapshot() or {}).get("counters", {})
    return {k: sum(counters.get(k, {}).values())
            for k in ("train.adam_kernel", "train.adam_plain")}


def checked(p, n: int):
    """Run the loop's first ``n`` iterations through its own call,
    ``run_segment(carry, 1)``, and copy what the reference needs to the
    host: ``(start, readings, rows, held)``: the state before them, the
    loop's readings (each iteration's loss, Adam's first moment after the
    first, the parameters after the last), what each iteration inserted
    (``p.route.rows``), and the seconds the copies took (the check's, not the
    program's)."""
    import time

    t = time.perf_counter()
    start = p.route.start(p)
    held = time.perf_counter() - t
    prog, rows = {"loss": []}, []
    for k in range(n):
        mark = p.route.mark(p)
        p.carry = p.run_segment(p.carry, 1)
        prog["loss"].append(float(p.carry.loss))
        t = time.perf_counter()
        rows.append(p.route.rows(p, mark))
        if k == 0:
            prog["m1"] = {name: _host(v)
                          for name, v in p.carry.opt_state.m.items()}
        held += time.perf_counter() - t
    t = time.perf_counter()
    prog.update(_params(p.carry))
    return start, prog, rows, held + time.perf_counter() - t
