"""The program's phase spans in a traced run, for the metrics that read
them.

The port marks phases inside its programs and its engine loop
(``repro_torch/runtime/phases.py``: ``forward``, ``backward``,
``optimizer`` a replica inside the local step; ``data``, ``keys``,
``readback``, ``observe`` in the loop; ``metrics_allreduce`` and
``allreduce`` on the mesh).  Its recorder records inside a
``torch.profiler`` session, which the traced run holds over exactly the
window, and keeps each record's host interval on ``time.time_ns()`` and
its CUDA event pair's elapsed time.  A run's records are ``run.phases``
where the run carries them, else those the program made in this
process's profiler sessions; none in an untraced run or in a program
without phase spans."""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Iterable, Optional


def of(run) -> list:
    recs = getattr(run, "phases", None)
    if recs is not None:
        return recs
    if run.trace is None:
        return []
    try:
        from repro_torch.runtime import phases
    except ImportError:              # a program without phase spans
        return []
    return phases.traced_records()


def median_per_iteration(run, names: Iterable[str],
                         device: bool = True) -> Optional[float]:
    """The median, over the iterations that hold any of the phases
    ``names``, of their sum within one iteration (every replica of this
    process), in ms: the CUDA event pairs' time (``device``) or the
    host's.  None where there is no such record, or one lacks its device
    time."""
    names = set(names)
    per_k = defaultdict(float)
    for r in of(run):
        if r.name not in names:
            continue
        ms = r.device_ms if device else r.host_ms
        if ms is None:
            return None
        per_k[r.k] += ms
    return statistics.median(per_k.values()) if per_k else None
