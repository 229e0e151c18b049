"""The comparison that decides ``correct`` for a training cell.

The program's readings and the reference's have one form: each step's
loss (``loss``), each leaf's norm of the first gradient as the optimizer's
state shows it (``grad``), and each leaf's norm of the weights' change
after the first three steps (``change``). From them:

* ``loss_gap``: the largest |program - reference| / |reference| over the
  steps' losses; ``loss1_gap`` the first step's alone;
* ``grad_gap`` and ``change_gap``: over the leaves, the largest gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
  ``grad_gap_median`` and ``change_gap_median`` the median leaf's gap;
  ``grad_gap.<leaf>`` and ``change_gap.<leaf>`` one leaf's gap.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of all four: rounding alone moves them. A leaf missing
from the program's readings, a number that the readings cannot give, or a
reading that is not a number, fails.
A cell compares the numbers its ``limits`` name, each against its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale


def moved_leaves(ref: Dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref["grad"].values())
    return [k for k, v in ref["grad"].items() if v >= 1e-3 * med]


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Each step's loss gap and each moved leaf's gap of ``grad`` and
    ``change``."""
    out = {"loss": [_gap(p, r, abs(r)) for p, r in
                    zip(list(prog["loss"]) + [math.nan] * 3, ref["loss"])]}
    leaves = moved_leaves(ref)
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        out[key] = {k: _gap(prog[key].get(k, math.nan), ref[key][k],
                            max(ref[key][k], med)) for k in leaves}
    return out


def _worst(values) -> float:
    worst = 0.0
    for v in values:
        if not v <= worst:            # a NaN sticks
            worst = v
    return worst


def _median(values) -> float:
    values = list(values)
    if any(v != v for v in values):
        return math.nan
    return statistics.median(values)


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    g = leaf_gaps(prog, ref)
    out = {"loss_gap": _worst(g["loss"]), "loss1_gap": g["loss"][0],
           "grad_gap": _worst(g["grad"].values()),
           "grad_gap_median": _median(g["grad"].values()),
           "change_gap": _worst(g["change"].values()),
           "change_gap_median": _median(g["change"].values())}
    for key in ("grad", "change"):
        out.update({f"{key}_gap.{k}": v for k, v in g[key].items()})
    return out


NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_median",
         "change_gap", "change_gap_median")


def known(name: str) -> bool:
    """Whether ``name`` is a number that ``numbers`` gives."""
    return name in NAMES or name.startswith(("grad_gap.", "change_gap."))


def judge(prog: Dict, ref: Dict, limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the cell's limits."""
    got = numbers(prog, ref)
    out = {k: {"value": got.get(k, math.nan), "limit": v}
           for k, v in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out


def lines(checks: Dict[str, Dict[str, Optional[float]]]) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())
