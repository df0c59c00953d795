"""The comparison that decides ``correct``.

Both sides give the same readings of the cell's first rounds from x0 on
the same batches (:mod:`bench.reference.pd_sgdm`): each step's loss, each
leaf's norm of the first gradient, and after the rounds each leaf's norm
of the change ``x − x0``, of the momentum and, for CPD-SGDM, of ``x̂ −
x0``.  Each number compared is a gap between the program's reading and
the reference's:

* ``loss_gap``: the largest ``|L_prog − L_ref| / |L_ref|`` over the steps;
* ``<reading>_gap`` for the leaf readings: by the worst leaf, the gap
  between the two norms over the reference's norm of that leaf or of the
  median leaf, whichever is larger.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's move by round-off alone; they are left out of the change,
momentum and x̂ gaps by that rule, never by name.
"""
from __future__ import annotations

import statistics

# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding and left out of the after-round gaps
NOUGHT = 1e-3
AFTER_ROUND = ("change", "momentum", "xhat")


def worst(values) -> float:
    """The largest of ``values``, or NaN if any is NaN (``max`` alone
    would depend on the order)."""
    values = list(values)
    if any(v != v for v in values):
        return float("nan")
    return max(values)


def moving_leaves(ref: dict) -> list:
    g = ref["grad1"]
    med = statistics.median(g.values())
    return [n for n, v in g.items() if v >= NOUGHT * med]


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return worst(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def numbers(prog: dict, ref: dict) -> dict:
    """The gaps between the program's readings and the reference's."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the two sides ran different numbers of steps")
    out = {"loss_gap": worst(abs(a - b) / abs(b)
                             for a, b in zip(prog["loss"], ref["loss"]))}
    out["grad1_gap"] = leaf_gap(prog["grad1"], ref["grad1"],
                                list(ref["grad1"]))
    keep = moving_leaves(ref)
    for key in AFTER_ROUND:
        if key in ref:
            out[f"{key}_gap"] = leaf_gap(prog[key], ref[key], keep)
    return out


def judge(nums: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit; checks
    maps each name to its value and limit, in the limits' order.  A number
    without a limit, or a limit without a number, is not correct."""
    checks = {name: {"value": nums.get(name), "limit": lim}
              for name, lim in limits.items()}
    for name, v in nums.items():
        checks.setdefault(name, {"value": v, "limit": None})
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
