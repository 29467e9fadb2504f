"""Phase spans inside the programs and the engine loop: the telemetry
layer's view below one program (``runtime/clock.py`` times whole
programs).

A ``PhaseRecorder`` rides the engine (``engine.phases``) and reaches the
programs through the backend, as the clock does: the backend's ``timed``
wrapper binds its recorder (``backend.phases``) around each program it
runs, and code inside marks a phase with
``with phases.current().phase("forward"):``.  The recorder
records while it is switched on (``on``; the engine does that under a
clock that times programs on the device, ``WallClock``) or while a
``torch.profiler`` session runs in this process, so that a profiled
window carries the phases on the profiler's clock:

* off: ``phase`` returns a shared no-op context; no host clock is read,
  no CUDA event is made, nothing is allocated;
* on: each phase becomes one ``PhaseRecord``: its name, the engine's
  iteration (``k``, stamped by the engine) and its host start and end on
  ``time.time_ns()`` (the profiler's clock);
* on, with the program's tensors on CUDA (``cuda``): also one CUDA event
  pair on the current stream.  No phase waits for the device: the events
  are read (``resolve``) after the fact, in one synchronize, or as they
  complete once many are pending.

Records made inside a profiler session are marked ``traced``, and every
recorder that made one is listed, so that whoever ran the session can
read them after the engine is gone (``traced_records``).
"""
from __future__ import annotations

from contextvars import ContextVar
from dataclasses import dataclass
from time import time_ns
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

# pending event pairs past which completed ones are read as phases open
_PENDING_READ = 512


@dataclass
class PhaseRecord:
    name: str
    k: int                       # the engine's iteration
    t0_ns: int                   # host start and end, time.time_ns()
    t1_ns: int
    device_ms: Optional[float] = None   # the CUDA event pair's elapsed time
    traced: bool = False         # made inside a torch.profiler session

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
_TRACED: List["PhaseRecorder"] = []


class _Open:
    __slots__ = ("rec", "name", "t0", "events")

    def __init__(self, rec: "PhaseRecorder", name: str):
        self.rec, self.name, self.events = rec, name, None

    def __enter__(self):
        if self.rec.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time_ns()
        rec = self.rec
        record = PhaseRecord(self.name, rec.k, self.t0, t1,
                             traced=_profiler._is_profiler_enabled)
        if self.events is not None:
            self.events[1].record()
            rec._pending.append((record,) + self.events)
            if len(rec._pending) >= _PENDING_READ:
                rec._read_completed()
        if record.traced and not rec._listed:
            rec._listed = True
            _TRACED.append(rec)
        rec.records.append(record)
        return False


class PhaseRecorder:
    """Phase records of one engine; off unless switched on (``on``) or a
    profiler session runs."""

    def __init__(self, cuda: bool = False):
        self.on = False
        self.cuda = cuda             # record CUDA event pairs
        self.k = 0                   # the engine's iteration
        self.records: List[PhaseRecord] = []
        self._pending: list = []     # (record, start event, end event)
        self._listed = False

    def phase(self, name: str):
        """A context around one phase of the program or the loop."""
        if not (self.on or _profiler._is_profiler_enabled):
            return NOOP
        return _Open(self, name)

    def _read_completed(self) -> None:
        """Read the pending event pairs the device has passed, without
        waiting."""
        left = []
        for rec, a, b in self._pending:
            if b.query():
                rec.device_ms = a.elapsed_time(b)
            else:
                left.append((rec, a, b))
        self._pending = left

    def resolve(self) -> List[PhaseRecord]:
        """Every record, with the device times of its event pairs read
        (one synchronize of each device that holds pending events)."""
        if self._pending:
            for dev in {b.device for _, _, b in self._pending}:
                torch.cuda.synchronize(dev)
            for rec, a, b in self._pending:
                rec.device_ms = a.elapsed_time(b)
            self._pending = []
        return self.records

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase totals: calls, host seconds and, where the phases
        carry CUDA events, device seconds."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.resolve():
            agg = out.setdefault(r.name, {"calls": 0, "host_s": 0.0})
            agg["calls"] += 1
            agg["host_s"] += r.host_ms / 1e3
            if r.device_ms is not None:
                agg["device_s"] = agg.get("device_s", 0.0) + r.device_ms / 1e3
        return out


# the recorder of code run outside a backend's program: off, but for a
# profiler session
UNRECORDED = PhaseRecorder()
_CURRENT: ContextVar[PhaseRecorder] = ContextVar("phases")


def current() -> PhaseRecorder:
    """The recorder bound around the program now running (``bound``),
    else ``UNRECORDED``."""
    return _CURRENT.get(UNRECORDED)


def bound(recorder: PhaseRecorder):
    """Bind ``recorder`` as ``current()``; returns the token that
    ``unbound`` takes."""
    return _CURRENT.set(recorder)


def unbound(token) -> None:
    _CURRENT.reset(token)


def traced_records() -> List[PhaseRecord]:
    """The records every recorder of this process made inside a
    ``torch.profiler`` session, resolved, in the order they were made."""
    out = [r for rec in _TRACED for r in rec.resolve() if r.traced]
    out.sort(key=lambda r: r.t0_ns)
    return out
