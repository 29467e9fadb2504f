"""The numbers that decide ``correct``: the program's first three
iterations against the reference's.

* ``loss_gap``: the largest |L_prog - L_ref| / |L_ref| over the three
  iterations' losses (each the mean over the replicas).
* ``s_k_gap``: the largest |S_prog - S_ref| / S_ref over the syncs among
  those iterations, S_k = (1/R)·Σ_i ||w̄ − w_i||² as the program's sync
  reports it (the sqdev half of the mean + sqdev kernel; on a mesh, the
  all-reduce of every rank's share).
* ``grad_gap``: over replicas and leaves, the largest gap between the
  program's and the reference's norm of the first gradient (the
  program's worked out from adamw's first moment after one step), over
  the larger of the reference's norm of that leaf and of the median leaf.
* ``delta_gap``: the same for each leaf's change after three iterations.
* ``grad_gap_median``, ``delta_gap_median``: the median over the leaves
  of those gaps (the largest over the replicas), which a single leaf's
  noise does not move.

Leaves whose reference gradient is below a thousandth of the median
leaf's (on every replica) move by rounding alone and are left out of
both leaf numbers.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

NOUGHT = 1e-3
NAMES = ("loss_gap", "s_k_gap", "grad_gap", "delta_gap", "grad_gap_median",
         "delta_gap_median")


def leaf_gaps(prog: Sequence[Sequence[float]],
              ref: Sequence[Sequence[float]],
              keep: Sequence[bool]) -> List[List[float]]:
    """Each replica's gap of each kept leaf's norm, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    out = []
    for p_r, q_r in zip(prog, ref):
        med = statistics.median(q_r)
        out.append([abs(p - q) / max(q, med)
                    for p, q, k in zip(p_r, q_r, keep) if k])
    return out


def gaps(prog: Dict[str, list], ref: Dict[str, list]) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (one a followed iteration),
    ``s_k`` (one a followed sync), ``grad_norms`` and ``delta_norms``
    (one list of leaf norms a replica, every replica, in replica order).
    A program that reports another number of syncs reads an infinite
    ``s_k_gap``."""
    g_ref = ref["grad_norms"]
    n_leaves = len(g_ref[0])
    keep = [any(g[i] >= NOUGHT * statistics.median(g) for g in g_ref)
            for i in range(n_leaves)]
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    s_k = (max(abs(a - b) / b for a, b in zip(prog["s_k"], ref["s_k"]))
           if len(prog["s_k"]) == len(ref["s_k"]) else float("inf"))
    grad = leaf_gaps(prog["grad_norms"], g_ref, keep)
    delta = leaf_gaps(prog["delta_norms"], ref["delta_norms"], keep)
    return {"loss_gap": loss, "s_k_gap": s_k,
            "grad_gap": max(max(r) for r in grad),
            "delta_gap": max(max(r) for r in delta),
            "grad_gap_median": max(statistics.median(r) for r in grad),
            "delta_gap_median": max(statistics.median(r) for r in delta)}


def verdict(values: Dict[str, float], limits: Optional[Dict]
            ) -> (bool, Dict[str, Dict[str, float]]):
    """(correct, {name: {value, limit}}): every number at or under its
    limit.  A limit of None is a number the cell does not compare (its
    readings are in PERF.md); no limits file means not correct."""
    out = {}
    ok = limits is not None
    for name in NAMES:
        v = values.get(name, float("nan"))
        lim = limits["limits"].get(name, float("nan")) if limits \
            else float("nan")
        out[name] = {"value": v, "limit": lim}
        if lim is not None:
            ok = ok and v == v and v <= lim
    return ok, out


def lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {n} {c['value']!r} limit {c['limit']!r}"
            for n, c in checks.items()]
