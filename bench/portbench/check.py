"""The comparison that decides ``correct``.

Both sides run the cell's first three rounds from the same weights,
batches and draws: the program through the timed path (set-up drives
the same runner the window then takes), the plain reference
(``bench/ref/``) after the window has closed. Each side gives each
round's mean client loss and clean-gradient norm, the per-leaf norms
of the first moment after round 1 (the first gradient as the optimizer
got it, times 1 - beta1), the per-leaf change of w after round 3 as
round 4 would see it, and on the int8 wire the per-leaf norms of the
carried residual. The numbers:

* ``loss_gap``: the largest relative gap of a round's loss;
* ``grad_gap``: the relative gap of round 1's clean-gradient norm (the
  clients' gradients of the same weights; from round 2 on the two sides'
  weights differ by their rounding, which rounds 2-3's losses show);
* ``first_grad_gap``, ``change_gap``: the worst leaf's gap between the
  two sides' norms, over the reference's norm of that leaf or of the
  median leaf, whichever is larger. ``change_gap`` leaves out the leaves
  whose round-1 clean gradient in the reference is under a thousandth of
  the median leaf's (a key bias under softmax: round-off);
* ``ef_gap``: the same gap of the residual's norms, of the median leaf:
  the worst leaf is the smallest (a 512-entry bias, four quantization
  blocks), where a few rounding decisions that flip with the clients'
  rounding move its norm by percents from seed to seed;
* ``launches_off``: the launches of B1-B5 in the window that differ from
  the traffic's launches a round times the rounds (on the card only).

Each number is held to its limit in ``bench/limits/<cell>.json``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

KEEP_SHARE = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def leaf_gaps(prog: List[float], ref: List[float],
              keep: Optional[List[bool]] = None) -> List[float]:
    """|p_i - r_i| / max(r_i, median r) over the kept leaves."""
    if any(not math.isfinite(p) for p in prog):
        return [math.inf]
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return [abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx]


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of one side (the program, or the control or
    a fault in its place) against the reference."""
    med = statistics.median(ref["clean1"])
    keep = [c >= KEEP_SHARE * med for c in ref["clean1"]]
    out = {
        "loss_gap": max(_rel(p, r) for p, r in zip(prog["loss"],
                                                  ref["loss"])),
        "grad_gap": _rel(prog["grad_norm"][0], ref["grad_norm"][0]),
        "first_grad_gap": max(leaf_gaps(prog["delta1"], ref["delta1"])),
        "change_gap": max(leaf_gaps(prog["change"], ref["change"], keep)),
    }
    if ref.get("ef") is not None:
        out["ef_gap"] = statistics.median(leaf_gaps(prog["ef"], ref["ef"]))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(nums: Dict[str, float], limits: dict):
    """(correct, {name: {"value", "limit"}}): every number of
    ``limits["compared"]`` within its limit. A number listed under
    ``limits["shown"]`` (one with no upper reading) is printed and not
    held; any other number, or one without its reading, fails."""
    compared = limits.get("compared", {})
    listed = set(compared) | set(limits.get("shown", ()))
    shown, ok = {}, bool(compared)
    for name in sorted(set(nums) | set(compared)):
        value = nums.get(name, math.inf)
        lim = compared.get(name)
        shown[name] = {"value": value, "limit": lim}
        if name not in listed or (lim is not None and not value <= lim):
            ok = False
    return ok, shown
