"""The device's idle gaps named by the program's phases, and what the
device does while the host is between the benchmark's program spans.

``devtrace.read_events`` names each idle gap by the benchmark's span open
on the host at its middle (``step (iteration 9)``), or as between
programs.  The program's phase records (``phase_records.py``) sit on the
same clock (``time.time_ns()``, the profiler's), so a gap can be named by
the innermost phase open at its middle (``forward (iteration 9)``), with
the span's name, or ``devtrace.BETWEEN``, where no phase is open."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from bench import devtrace

NO_PHASE = "no phase (engine and benchmark glue)"


def _innermost(phases, at: int):
    """The phase open at ``at`` that started last, or None."""
    best = None
    for r in phases:
        if r.t0_ns <= at <= r.t1_ns and (best is None or r.t0_ns > best.t0_ns):
            best = r
    return best


def _span_label(spans: Sequence[tuple], at: int) -> str:
    notes = sorted((s[4], s[5], f"{s[0]} (iteration {s[1]})") for s in spans)
    i = bisect.bisect_right([n[0] for n in notes], at) - 1
    return notes[i][2] if i >= 0 and notes[i][1] >= at else devtrace.BETWEEN


def idle_gaps(kernels: Sequence[Tuple[int, int]], t0_ns: int, t1_ns: int
              ) -> List[Tuple[int, int]]:
    """The window [t0_ns, t1_ns] less the union of the device intervals
    ``kernels``: the idle gaps, in time order."""
    merged = devtrace._merge([(max(a, t0_ns), min(b, t1_ns))
                              for a, b in kernels
                              if min(b, t1_ns) > max(a, t0_ns)])
    edges = [t0_ns] + [x for ab in merged for x in ab] + [t1_ns]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_gaps_by_phase(kernels, t0_ns: int, t1_ns: int,
                       spans: Sequence[tuple], phases, n: int = 10
                       ) -> List[list]:
    """The ``n`` longest idle gaps, [name, seconds] each, longest first:
    named by the innermost phase open on the host at the gap's middle
    (``"<phase> (iteration <k>)"``), else as ``devtrace.read_events``
    names them (the span, or between programs)."""
    out = []
    for a, b in idle_gaps(kernels, t0_ns, t1_ns):
        mid = (a + b) // 2
        r = _innermost(phases, mid)
        label = (f"{r.name} (iteration {r.k})" if r is not None
                 else _span_label(spans, mid))
        out.append([label, (b - a) / 1e9])
    out.sort(key=lambda g: -g[1])
    return out[:n]


def _overlap(a: int, b: int, intervals) -> int:
    return sum(max(0, min(b, y) - max(a, x)) for x, y in intervals)


def outside_spans(kernels: Sequence[Tuple[int, int, str]], t0_ns: int,
                  t1_ns: int, spans: Sequence[tuple], phases,
                  n: int = 8) -> Dict[str, object]:
    """The host's time in the window outside every span, in seconds: by
    the innermost phase open (``NO_PHASE`` where none is), and the
    device's busy time meanwhile, by kernel name (the ``n`` largest)."""
    inside = devtrace._merge([(s[4], s[5]) for s in spans])
    edges = [t0_ns] + [x for ab in inside for x in ab] + [t1_ns]
    gaps = [(max(a, t0_ns), min(b, t1_ns))
            for a, b in zip(edges[0::2], edges[1::2])]
    gaps = [(a, b) for a, b in gaps if b > a]
    # split each gap at the phases' edges; each piece takes the phase open
    # at its middle
    cuts = sorted({x for r in phases for x in (r.t0_ns, r.t1_ns)})
    host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        points = [a] + cuts[bisect.bisect_right(cuts, a):
                            bisect.bisect_left(cuts, b)] + [b]
        for x, y in zip(points, points[1:]):
            r = _innermost(phases, (x + y) // 2)
            host[r.name if r is not None else NO_PHASE] += (y - x) / 1e9
    busy: Dict[str, float] = defaultdict(float)
    for a, b, name in kernels:
        s = _overlap(a, b, gaps)
        if s:
            busy[name] += s / 1e9
    merged = devtrace._merge([(a, b) for a, b, _ in kernels])
    return {"host_s": sum(b - a for a, b in gaps) / 1e9,
            "host_s_by_phase": dict(sorted(host.items(),
                                           key=lambda kv: -kv[1])),
            "device_busy_s": sum(_overlap(a, b, merged)
                                 for a, b in gaps) / 1e9,
            "device_busy_s_by_kernel": sorted(
                ([k[:100], s] for k, s in busy.items()),
                key=lambda x: -x[1])[:n]}
