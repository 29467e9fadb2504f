"""Telemetry clocks: wall-clock and simulated time for the training loop
(port of ``repro/runtime/clock.py``).

The paper's headline claims are wall-clock claims (1.14-1.27x over
FULLSGD at 100 Gbps, 1.46-1.95x at 10 Gbps).  A ``Clock`` is bound to the
``ExecutionBackend`` (``backend.set_clock``); every program the backend
lowers is wrapped by ``backend.timed(...)`` and reports one
``ProgramTiming`` — ``(compute_s, comm_s, bytes)`` — per invocation into
the clock's ``Timeline``.

* ``WallClock``      — ``time.monotonic()`` around each program, which
  ends in ``torch.cuda.synchronize(device)`` when the program's tensors
  are on CUDA (on the CPU the program has finished when it returns).  A
  fused program cannot split its time, so the whole measurement goes to
  the program's primary cost: compute for step programs, communication
  for sync programs; the modeled bytes ride along either way.
* ``SimulatedClock`` — never synchronizes and never reads the host clock.
  Compute is charged per step program (``step_compute_s`` times the
  ``straggler`` slowdown) and communication from ``core/comm_model.py``'s
  per-collective ``comm_time`` under a ``NetworkModel`` (``10gbps`` /
  ``100gbps`` / ``<x>gbps``).  Simulated time is a pure function of the
  dispatch sequence, so its records equal the reference's float for float.

Both clocks understand overlap ops (``backends/ops.py``): an
``overlap=True`` collective goes through ``dispatch_async`` — recorded
with ``overlap=True`` but neither waited for (WallClock) nor advancing
simulated time (SimulatedClock) — and is settled when the caller fetches
the ``InFlightOp``: the WallClock waits there and records the stall as a
``<name>.fetch`` record, the SimulatedClock advances only by the
un-overlapped remainder ``max(0, t_end − now)``.

``WallClock(sample_every=N)`` waits only on every N-th engine step and
interpolates the records in between: the real time elapsed since the
previous sample is spread over the window's records, so per-window totals
equal real wall time and per-record values say they are estimates
(``ProgramTiming.interpolated``).

Clock state is training state (the time-based AdaComm schedule continues
mid-block across a restore): ``state_dict`` / ``load_state_dict``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.backends.ops import settle
from repro_torch.core.comm_model import GBPS_10, GBPS_100, LATENCY_S, comm_time
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class NetworkModel:
    """The simulated link: the paper's 100 Gbps InfiniBand vs. the
    throttled 10 Gbps, plus the in-pod link hierarchical inner syncs ride
    (``intra_bandwidth``, defaults to the cross-pod bandwidth)."""

    name: str = "100gbps"
    bandwidth: float = GBPS_100          # bytes/s, cross-replica link
    latency_s: float = LATENCY_S         # per hop
    intra_bandwidth: Optional[float] = None   # in-pod link (inner_mean)

    @property
    def intra(self) -> float:
        return self.intra_bandwidth or self.bandwidth


_NETS = {
    "10gbps": NetworkModel("10gbps", GBPS_10),
    "100gbps": NetworkModel("100gbps", GBPS_100),
}


def resolve_net(spec) -> NetworkModel:
    """``'10gbps'`` / ``'100gbps'`` / ``'<x>gbps'`` / NetworkModel."""
    if isinstance(spec, NetworkModel):
        return spec
    s = str(spec).lower()
    if s in _NETS:
        return _NETS[s]
    if s.endswith("gbps"):
        return NetworkModel(s, float(s[:-4]) * 1e9 / 8)
    raise ValueError(f"unknown network '{spec}'; "
                     f"use one of {sorted(_NETS)} or '<x>gbps'")


@dataclass
class ProgramTiming:
    """One program invocation's cost report."""

    name: str                 # program name ("all_mean", "replica_step", …)
    step: int                 # engine iteration the dispatch belonged to
    compute_s: float = 0.0
    comm_s: float = 0.0
    bytes: float = 0.0        # modeled bytes per node moved by the program
    t_start: float = 0.0      # clock coordinates
    t_end: float = 0.0
    overlap: bool = False     # dispatched off the step path (InFlightOp)
    interpolated: bool = False  # sampled-WallClock estimate


class Timeline:
    """Per-invocation ``ProgramTiming`` records plus running aggregates.
    The engine stamps ``timeline.step`` before each iteration's
    dispatches."""

    def __init__(self):
        self.records: List[ProgramTiming] = []
        self.step = 0
        self.compute_s = 0.0
        self.comm_s = 0.0
        self.bytes = 0.0
        self.by_program: Dict[str, Dict[str, float]] = {}

    def record(self, t: ProgramTiming) -> None:
        self.records.append(t)
        self.compute_s += t.compute_s
        self.comm_s += t.comm_s
        self.bytes += t.bytes
        agg = self.by_program.setdefault(
            t.name, {"calls": 0, "compute_s": 0.0, "comm_s": 0.0,
                     "bytes": 0.0})
        agg["calls"] += 1
        agg["compute_s"] += t.compute_s
        agg["comm_s"] += t.comm_s
        agg["bytes"] += t.bytes

    def amend(self, t: ProgramTiming, *, d_compute: float = 0.0,
              d_comm: float = 0.0) -> None:
        """Adjust an already-recorded timing (the sampled WallClock's
        window reconciliation), keeping the aggregates consistent."""
        t.compute_s += d_compute
        t.comm_s += d_comm
        t.t_end += d_compute + d_comm
        self.compute_s += d_compute
        self.comm_s += d_comm
        agg = self.by_program[t.name]
        agg["compute_s"] += d_compute
        agg["comm_s"] += d_comm

    @property
    def last(self) -> Optional[ProgramTiming]:
        return self.records[-1] if self.records else None

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s

    def summary(self) -> Dict[str, Any]:
        return {"compute_s": self.compute_s, "comm_s": self.comm_s,
                "total_s": self.total_s, "bytes": self.bytes,
                "n_records": len(self.records),
                "by_program": {k: dict(v)
                               for k, v in self.by_program.items()}}


class Clock:
    """Base: owns the ``Timeline``; concrete clocks implement ``now`` and
    ``measure`` (called by ``ExecutionBackend.timed`` wrappers)."""

    kind = "base"

    def __init__(self):
        self.timeline = Timeline()

    def now(self) -> float:
        raise NotImplementedError

    def straggler_factor(self) -> float:
        """Slowest-replica slowdown (>= 1) the wall-clock AdaComm
        controller rescales its period by; 1 when unknown."""
        return 1.0

    def comm_cost(self, comm_bytes: float, collective: Optional[str],
                  n_nodes: int) -> float:
        """Modeled seconds for one collective — 0 unless the clock
        simulates a network."""
        return 0.0

    def measure(self, name: str, fn, args, *, is_step: bool,
                comm_bytes: float = 0.0, collective: Optional[str] = None,
                n_nodes: int = 1):
        """Run program ``fn(*args)`` and record one ``ProgramTiming``."""
        raise NotImplementedError

    def dispatch_async(self, name: str, fn, args, *,
                       comm_bytes: float = 0.0,
                       collective: Optional[str] = None,
                       n_nodes: int = 1) -> Tuple[Any, Optional[ProgramTiming]]:
        """Dispatch an ``overlap=True`` collective off the step path;
        returns ``(outputs, record)``.  Base: a synchronous ``measure``."""
        out = self.measure(name, fn, args, is_step=False,
                           comm_bytes=comm_bytes, collective=collective,
                           n_nodes=n_nodes)
        return out, None

    def complete_async(self, name: str, record: Optional[ProgramTiming],
                       outputs=None):
        """Settle an overlap op at fetch time and return its outputs
        (``backends.ops.settle``: a ``Deferred`` is finished here).  Base:
        already paid."""
        return settle(outputs)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "t": self.now()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError


def _wait(outputs) -> None:
    """Wait until the device has finished ``outputs``: synchronize the
    CUDA device their tensors live on.  CPU tensors are finished when the
    program returns, so nothing is waited for.  On a mesh over NCCL the
    device synchronisation also covers NCCL's own streams, which the
    program's collectives ran on, so no barrier is needed."""
    for x in tree_leaves(outputs):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return


class WallClock(Clock):
    """Real elapsed time: ``time.monotonic()`` around each program, which
    is waited for on its device.  ``load_state_dict`` re-bases the epoch so
    a restored run's ``now()`` continues from the saved time.

    ``sample_every=N`` (default 1: wait after every program) waits only on
    engine steps where ``step % N == 0``.  Unsampled programs return at
    once and get the last sampled duration of their program as a
    provisional value; at the next sample the real time elapsed since the
    previous one is spread over the window's records in proportion to
    their estimates (``Timeline.amend``).  ``n_blocks`` counts the waits
    actually made (the samples)."""

    kind = "wall"

    def __init__(self, *, sample_every: int = 1):
        super().__init__()
        self.sample_every = max(1, int(sample_every))
        self._start = time.monotonic()
        self._base = 0.0
        self.n_blocks = 0
        self._est: Dict[str, float] = {}      # last sampled dt per program
        self._mark: Optional[float] = None    # end of the last sample
        # interpolated records since the last sample: (record, is_step)
        self._window: List[Tuple[ProgramTiming, bool]] = []

    @property
    def defer_loss_readback(self) -> bool:
        """The engine's per-step ``float(loss)`` would synchronize the
        device every step: ask it to defer the read to run end."""
        return self.sample_every > 1

    def now(self) -> float:
        return time.monotonic() - self._start + self._base

    def _record(self, name, dt, *, is_step, comm_bytes, t0,
                interpolated=False):
        rec = ProgramTiming(
            name=name, step=self.timeline.step,
            compute_s=dt if is_step else 0.0,
            comm_s=0.0 if is_step else dt,
            bytes=comm_bytes, t_start=t0, t_end=t0 + dt,
            interpolated=interpolated)
        self.timeline.record(rec)
        return rec

    def measure(self, name, fn, args, *, is_step, comm_bytes=0.0,
                collective=None, n_nodes=1):
        t0 = self.now()
        out = fn(*args)
        if self.sample_every > 1 and self.timeline.step % self.sample_every:
            rec = self._record(name, self._est.get(name, 0.0),
                               is_step=is_step, comm_bytes=comm_bytes,
                               t0=t0, interpolated=True)
            self._window.append((rec, is_step))
            return out
        _wait(out)
        self.n_blocks += 1
        t1 = self.now()
        dt = t1 - t0
        own = dt
        if self.sample_every > 1:
            if self._mark is None:
                self._mark = t0
            # real time since the previous sample: the window's queued
            # work finished inside this wait, plus this program's own run
            elapsed = t1 - self._mark
            self._mark = t1
            est = self._est.get(name)
            if self._window:
                own = min(dt, est) if est is not None else dt
                target = max(0.0, elapsed - own)
                total = sum(r.compute_s + r.comm_s for r, _ in self._window)
                n = len(self._window)
                for r, r_is_step in self._window:
                    w = ((r.compute_s + r.comm_s) / total if total > 0
                         else 1.0 / n)
                    d = w * target - (r.compute_s + r.comm_s)
                    self.timeline.amend(r, d_compute=d if r_is_step else 0.0,
                                        d_comm=0.0 if r_is_step else d)
                self._window = []
            self._est[name] = own
        self._record(name, own, is_step=is_step, comm_bytes=comm_bytes, t0=t0)
        return out

    def dispatch_async(self, name, fn, args, *, comm_bytes=0.0,
                       collective=None, n_nodes=1):
        t0 = self.now()
        out = fn(*args)                   # queued on the stream, not waited
        rec = ProgramTiming(name=name, step=self.timeline.step,
                            bytes=comm_bytes, t_start=t0, t_end=t0,
                            overlap=True)
        self.timeline.record(rec)
        return out, rec

    def complete_async(self, name, record, outputs=None):
        t0 = self.now()
        outputs = settle(outputs)
        if outputs is not None:
            _wait(outputs)
            self.n_blocks += 1
        dt = self.now() - t0
        if record is not None:
            record.t_end = t0 + dt        # the exchange was done by here
        # the observed stall: the exchange's only charge in the aggregates
        self.timeline.record(ProgramTiming(
            name=f"{name}.fetch", step=self.timeline.step, comm_s=dt,
            t_start=t0, t_end=t0 + dt))
        if self._mark is not None:
            # sampled mode: keep this stall out of the next window's span
            self._mark += dt
        return outputs

    def load_state_dict(self, state):
        self._base = float(state.get("t", 0.0))
        self._start = time.monotonic()


class SimulatedClock(Clock):
    """Deterministic time: compute charged per step program, communication
    from the per-collective analytic model.  Never synchronizes, so the
    run is bit-identical to an unclocked one."""

    kind = "sim"

    def __init__(self, net="100gbps", *, step_compute_s: float = 5e-3,
                 straggler: float = 1.0):
        super().__init__()
        self.net = resolve_net(net)
        self.step_compute_s = float(step_compute_s)
        if straggler < 1.0:
            raise ValueError("straggler slowdown must be >= 1")
        self.straggler = float(straggler)
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def straggler_factor(self) -> float:
        return self.straggler

    def comm_cost(self, comm_bytes, collective, n_nodes):
        if collective is None or n_nodes <= 1:
            return 0.0
        bw = self.net.intra if collective == "inner_mean" else \
            self.net.bandwidth
        return comm_time(comm_bytes, 1, n_nodes, bw, collective=collective,
                         latency_s=self.net.latency_s)

    def measure(self, name, fn, args, *, is_step, comm_bytes=0.0,
                collective=None, n_nodes=1):
        out = fn(*args)
        # every replica waits for the slowest at the next collective
        compute = self.step_compute_s * self.straggler if is_step else 0.0
        comm_s = self.comm_cost(comm_bytes, collective, n_nodes)
        t0 = self._t
        self._t += compute + comm_s
        self.timeline.record(ProgramTiming(
            name=name, step=self.timeline.step, compute_s=compute,
            comm_s=comm_s, bytes=comm_bytes, t_start=t0, t_end=self._t))
        return out

    def dispatch_async(self, name, fn, args, *, comm_bytes=0.0,
                       collective=None, n_nodes=1):
        """The exchange's full cost is recorded off the step path
        (``overlap=True``, ``t_end`` when the wire would be done); the
        simulated time does not advance."""
        out = fn(*args)
        comm_s = self.comm_cost(comm_bytes, collective, n_nodes)
        rec = ProgramTiming(name=name, step=self.timeline.step,
                            comm_s=comm_s, bytes=comm_bytes,
                            t_start=self._t, t_end=self._t + comm_s,
                            overlap=True)
        self.timeline.record(rec)
        return out, rec

    def complete_async(self, name, record, outputs=None):
        """Fetch: advance by the un-overlapped remainder only.  The fetch
        record shows the stall as its duration with ``comm_s=0``: the
        exchange was charged at dispatch."""
        outputs = settle(outputs)
        wait = 0.0
        if record is not None:
            wait = max(0.0, record.t_end - self._t)
            self._t += wait
        self.timeline.record(ProgramTiming(
            name=f"{name}.fetch", step=self.timeline.step,
            t_start=self._t - wait, t_end=self._t))
        return outputs

    def state_dict(self):
        d = super().state_dict()
        d["net"] = self.net.name
        return d

    def load_state_dict(self, state):
        self._t = float(state.get("t", 0.0))


def make_clock(spec, *, wallclock_sample_every: int = 1) -> Optional[Clock]:
    """CLI-flag resolution: ``None``/``'none'`` -> no clock,
    ``'real'``/``'wall'`` -> WallClock, anything else -> SimulatedClock on
    that network (``'10gbps'``, ``'100gbps'``, ``'<x>gbps'``)."""
    if spec is None or isinstance(spec, Clock):
        return spec
    s = str(spec).lower()
    if s in ("", "none"):
        return None
    if s in ("real", "wall"):
        return WallClock(sample_every=wallclock_sample_every)
    return SimulatedClock(s)
