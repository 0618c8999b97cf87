"""The comparison that decides ``correct``.

The plain reference (``reference/``) follows the loop's first three
iterations from the loop's own state before them, drawing the same random
numbers, and the numbers below set what the loop produced against what
the reference did. Each has its limit in the cell's file (``limits``);
``correct`` holds when every number is finite and within its limit.

* ``loss_gap``: the largest over the three iterations of the relative gap
  between the loop's loss and the reference's.
* ``grad_gap``: Adam's first moment after the first iteration (``0.1 g``
  of the first gradient at one update per iteration, their running
  average at more), by the worst leaf: the gap between the two norms of a
  leaf over the larger of the reference's norm of that leaf and of the
  median leaf.
* ``change_gap``: the change of the parameters and of the target
  parameters over the three iterations, by the worst leaf, measured as
  ``grad_gap``; a leaf whose reference first moment is under a
  thousandth of the median leaf's moves by round-off alone and is left
  out.
* ``prio_gap``: the replay's priorities (the sum tree's leaves) after
  each iteration, the relative L2 gap between the loop's and the
  reference's, the largest over the three; the reference then takes the
  loop's priorities (``reference/loop.py::Follow.judge_priorities``).
* ``td1_gap``: the same gap over the priorities that the first update
  wrote, from the TD errors of the parameters both sides start from: the
  one number that no earlier update of either side has moved apart.
* ``rows_bad``: rows the loop inserted that differ from the reference's in
  any field, counted exactly. A greedy action that differs from the
  reference's is taken as the loop's where its Q value is within the
  reference's tie tolerance of the best (``reference/loop.py``). Over an
  episode replay, per iteration, the envs whose new ring row differs and
  the envs whose episode records (every ``(start, length)``, the record
  count and the open episode's length) differ (``reference/drqn.py``).
* ``hidden_gap`` (a recurrent loop): the actor's recurrent state ``(h,
  c)`` after each iteration, the relative L2 gap between the loop's and
  the reference's, the largest over the three.

A cell is judged on the numbers its file's ``limits`` name: a
feed-forward cell on the first six, a recurrent one (an episode replay,
no priorities) on ``loss_gap``, ``grad_gap``, ``change_gap``, ``rows_bad``
and ``hidden_gap``.

Each limit lies between two readings taken on the card: the largest that
sound runs of the port gave over a dozen seeds or more, and the smallest
that the control (the reference in the precision just below the
configuration's, in the port's place) or a planted fault gave
(``readings.py``); ``PERF.md`` lists both.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def leaf_gap(ours: Dict[str, float], ref: Dict[str, float], keep=None):
    """The worst leaf's gap between two sets of leaf norms, over the larger
    of the reference's norm of the leaf and of the median parameter leaf
    (a target leaf, which stands still between syncs, is not counted into
    the median)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = _median([ref[k] for k in keys if not k.startswith("target.")])
    return max(abs(ours[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def numbers(start: dict, prog: dict, ref: dict) -> Dict[str, float]:
    """The correctness numbers from the loop's readings ``prog`` (``loss``
    per iteration, ``m1``, ``params``, ``target``) and the
    reference's ``ref`` (``reference.loop.follow``), both from ``start``."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    if any(not math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    m_ref, m_prog = _norms(ref["m1"]), _norms(prog["m1"])
    grad = leaf_gap(m_prog, m_ref)
    med = _median(list(m_ref.values()))
    moved = {k for k, v in m_ref.items() if v >= 1e-3 * med}
    keep = moved | {"target." + k for k in moved}

    def change(end):
        d = {k: end["params"][k].double().cpu()
             - start["params"][k].double() for k in start["params"]}
        d.update({"target." + k: end["target"][k].double().cpu()
                  - start["target"][k].double() for k in start["target"]})
        return _norms(d)

    ch = leaf_gap(change({k: prog[k] for k in ("params", "target")}),
                  change(ref), keep)
    return dict(loss_gap=loss, grad_gap=grad, change_gap=ch, **ref["judged"])


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's ``limits`` name is finite and within its
    limit (a number the run did not give fails)."""
    return all(math.isfinite(nums.get(k, math.nan)) and nums[k] <= v
               for k, v in limits.items())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.cpu().double()
    return float((a.cpu().double() - b).norm() / b.norm())


def unchanged(start: dict, ref: dict) -> Dict[str, float]:
    """The numbers of a step that returns its state unchanged, read
    without a run: the loss stays the carry's, nothing moves, no row is
    written, and the priorities or the recurrent state stay the start's."""
    prog = dict(loss=[0.0] * len(ref["loss"]),
                m1={k: torch.zeros_like(v) for k, v in ref["m1"].items()},
                params=start["params"], target=start["target"])
    out = numbers(start, prog, ref)
    if "tree" in ref:
        out["prio_gap"] = _rel(start["tree"][0], ref["tree"][0])
        out["td1_gap"] = out["prio_gap"]
    else:
        out["hidden_gap"] = max(_rel(start["hidden"], h)
                                for h in ref["hidden"])
    out["rows_bad"] = float(len(ref["loss"]) * start["obs"].shape[0])
    return out
