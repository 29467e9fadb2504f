"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
alone over the whole window (kernels, copies and sets on the device, with
no record of each host operation, which would double a step's time), read
into kernel intervals.  The profiler's clock is the host's wall clock
(``time.time_ns``), so the benchmark's program spans, taken on that clock
too, name each idle gap by the program the host was running."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

from bench import yardstick

BETWEEN = "between programs (engine, data, loss readback)"


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """The profiler's first use starts CUPTI, which takes seconds: one
    short profile in set-up keeps that out of the window."""
    with _profile():
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by kernel name
    gaps: List[Tuple[str, float]]       # idle gaps, longest first
    programs: Dict[str, int] = field(default_factory=dict)  # calls traced

    def seconds_matching(self, keys) -> float:
        return sum(s for n, s in self.kernel_s.items()
                   if any(k in n for k in keys))

    def top_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{yardstick.category(k)}: {k[:120]}", s] for k, s in top]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[name, s] for name, s in self.gaps[:n]]


class Tracer:
    """Profiles the window: ``start`` before its first iteration, ``stop``
    after its last synchronize; reading the events happens after the
    window's time is taken."""

    def __init__(self):
        self.prof = None
        self.result: DeviceTrace | None = None

    def start(self) -> None:
        self.prof = _profile()
        self.prof.__enter__()
        torch.cuda.synchronize()

    def stop(self, t0_ns: int, t1_ns: int, spans: Sequence[tuple]) -> None:
        self.prof.__exit__(None, None, None)
        self.result = read_events(self.prof.profiler.kineto_results.events(),
                                  t0_ns, t1_ns, spans)
        self.prof = None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_events(events, t0_ns: int, t1_ns: int,
                spans: Sequence[tuple]) -> DeviceTrace:
    """Device intervals clipped to the window [t0_ns, t1_ns]; busy time is
    their union; each idle gap is named by the span (name, iteration)
    open on the host at its middle.  ``spans``: (name, k, perf_counter
    start, end, time_ns start, end)."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = []
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a, b = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
        if b <= a:
            continue
        name = e.name()
        kernels.append((a, b))
        kernel_s[name] += (b - a) / 1e9
    merged = _merge(kernels)
    busy = sum(b - a for a, b in merged) / 1e9
    edges = [t0_ns] + [x for ab in merged for x in ab] + [t1_ns]
    notes = sorted((s[4], s[5], f"{s[0]} (iteration {s[1]})") for s in spans)
    starts = [n[0] for n in notes]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = notes[i][2] if i >= 0 and notes[i][1] >= mid else BETWEEN
        gaps.append((label, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    programs: Dict[str, int] = defaultdict(int)
    for s in spans:
        programs[s[0]] += 1
    return DeviceTrace((t1_ns - t0_ns) / 1e9, busy, dict(kernel_s), gaps,
                       dict(programs))
