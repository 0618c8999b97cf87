"""Work counted from shapes, the card's peaks and the traffic's sizes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
67 TFLOP/s in f32 on the CUDA cores (TF32 off), 989 TFLOP/s in bf16 on
the tensor cores, 3.35 TB/s of HBM3. A FLOP is half a multiply-add.
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
F32_PEAK = PEAK_FLOPS["float32"]


def bound_s(flops: float, nbytes: float, peak_flops: float = F32_PEAK):
    """The least time the card takes for the work: the larger of the
    operations over the FLOP rate and the bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def traffic(config: dict, cell: dict) -> dict:
    """The loop's sizes from a cell's traffic (the solver's arithmetic:
    ``train_freq`` env steps per update); a recurrent configuration
    (``recurrence``) adds its ``trace_length`` and populates as ``solve``
    does, for at least ``max_episode_length + 1`` lockstep steps.
    ``buffer_size`` counts rows, or a recurrent replay's episodes."""
    E, tf = cell["num_envs"], cell["train_freq"]
    steps = max(1, tf // E)
    if E % tf and tf % E:
        raise ValueError("num_envs and train_freq must divide one another")
    if steps != 1:
        raise ValueError("the benchmark runs one collect step per iteration")
    U = max(1, E * steps // tf)
    out = dict(
        num_envs=E, train_freq=tf, batch_size=cell["batch_size"],
        buffer_size=cell.get("buffer_size", config.get("replay_capacity")),
        target_update_freq=cell["target_update_freq"],
        train_start=cell["train_start"], populate_steps=math.ceil(
            cell["train_start"] / E),
        segment_iters=cell["segment_iters"], updates_per_iter=U,
        env_steps_per_iter=E * steps,
        max_episode_length=config["max_episode_length"])
    if "recurrence" in config:
        # solve's floor: every env commits an episode before the first draw
        out["populate_steps"] = max(out["populate_steps"],
                                    config["max_episode_length"] + 1)
        out["trace_length"] = config["recurrence"]["trace_length"]
    return out


def forward_flops(net) -> int:
    """FLOPs of one sample's forward through the dueling network ``net``
    (``reference.nets.Net``: each layer's multiply-adds from its kind's
    file)."""
    return 2 * sum(sum(m) for m in net.macs())


def first_layer_flops(net) -> int:
    """FLOPs of the layers that read the observation: their input
    gradient is never taken (the base's first layer with parameters, or
    both heads' first where the base has none; of a recurrent cell only
    its input product, ``Net.first_macs``)."""
    return 2 * net.first_macs()


def step_flops(net, config: dict, tr: dict) -> int:
    """Model FLOPs of one iteration, no recomputation counted: the
    collect's forward over every env, and per sub-update the forward on s
    with its backward (each layer's weight gradient and every input
    gradient but the observation's), the online forward on s' (double-Q)
    and the target forward on s', for each of its rows, or of a recurrent
    update's B·T window steps."""
    f = forward_flops(net)
    per_row = f + f * (2 if config["double_q"] else 1) + f + (
        f - first_layer_flops(net))
    return tr["num_envs"] * f + tr["updates_per_iter"] * tr[
        "batch_size"] * tr.get("trace_length", 1) * per_row


def obs_numel(config: dict) -> int:
    n = 1
    for s in config["env"]["obs_shape"]:
        n *= s
    return n


def tree_levels(capacity: int, branch: int = 64):
    """Node counts of the replay's sum tree, leaves first."""
    cap = 1
    while cap < capacity:
        cap *= 2
    sizes = [cap]
    while sizes[-1] > 1:
        s = sizes[-1]
        sizes.append(s // (branch if s % branch == 0 and s >= branch else s))
    return sizes
