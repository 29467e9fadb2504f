"""The readers of the program's phase spans (``phase_records.py``, the
six ``metrics/*_ms.py`` that read them) and the naming of idle gaps by
phase (``phase_gaps.py``), on hand-made runs and intervals."""
import sys

import pytest

from bench import devtrace, harness, phase_gaps, phase_records
from bench.cells import load_cell, reader
from repro_torch.runtime.phases import PhaseRecord

DEVICE = {"forward_ms": ("forward",), "backward_ms": ("backward",),
          "optimizer_ms": ("optimizer",),
          "mesh_step_wait_ms": ("metrics_allreduce",),
          "mesh_allreduce_ms": ("allreduce",)}
NEW = sorted(DEVICE) + ["engine_host_ms"]


def _run(phases=None, traced=True):
    run = harness.Run(cell=load_cell("olmo1b-adpsgd-ddp4"), chips=4,
                      setup_s=1.0, window_s=1.0, steps=3, syncs=1,
                      tokens=1, peak_bytes=1, flops_per_step=1.0,
                      leaf_shapes=[],
                      trace=devtrace.DeviceTrace(1.0, 0.9, {}, [])
                      if traced else None)
    if phases is not None:
        run.phases = phases
    return run


def _rec(name, k, device_ms=None, host_ms=1.0, t0=0):
    return PhaseRecord(name, k, t0, t0 + int(host_ms * 1e6), device_ms)


@pytest.mark.parametrize("metric", NEW)
def test_none_without_phases(metric):
    assert reader(metric)(_run([])) is None
    assert reader(metric)(_run(traced=False)) is None


@pytest.mark.parametrize("metric", NEW)
def test_none_on_a_program_without_phase_spans(metric, monkeypatch):
    """A program that has no phase recorder (the parent of the change
    that brings it): the reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.phases", None)
    assert reader(metric)(_run()) is None


@pytest.mark.parametrize("metric", sorted(DEVICE))
def test_device_median_over_iterations(metric):
    """Summed over the replicas within an iteration, median over the
    iterations; other phases and host times do not count."""
    name = DEVICE[metric][0]
    recs = [_rec(name, 4, 2.0), _rec(name, 4, 3.0), _rec(name, 5, 7.0),
            _rec(name, 6, 1.0), _rec(name, 6, 1.0), _rec(name, 7, 9.0),
            _rec("data", 4, None, 50.0), _rec("observe", 5, 0.5)]
    assert reader(metric)(_run(recs)) == pytest.approx(6.0)


@pytest.mark.parametrize("metric", sorted(DEVICE))
def test_device_time_missing_reads_none(metric):
    name = DEVICE[metric][0]
    assert reader(metric)(_run([_rec(name, 4, 2.0), _rec(name, 5)])) is None


def test_engine_host_ms_sums_the_loop_phases():
    recs = [_rec("data", 4, host_ms=0.5), _rec("keys", 4, host_ms=0.25),
            _rec("keys", 4, host_ms=0.25), _rec("readback", 4, host_ms=1.0),
            _rec("observe", 4, host_ms=2.0),
            _rec("data", 5, host_ms=1.0), _rec("observe", 5, host_ms=1.0),
            _rec("forward", 5, 100.0, host_ms=100.0),
            _rec("data", 6, host_ms=9.0)]
    assert reader("engine_host_ms")(_run(recs)) == pytest.approx(4.0)


def test_records_come_from_the_program_in_a_traced_run(monkeypatch):
    from repro_torch.runtime import phases
    recs = [_rec("forward", 4, 2.0)]
    monkeypatch.setattr(phases, "traced_records", lambda: recs)
    assert phase_records.of(_run()) is recs
    assert phase_records.of(_run(traced=False)) == []
    assert reader("forward_ms")(_run()) == 2.0


def _span(name, k, t0, t1):
    return (name, k, t0 / 1e9, t1 / 1e9, t0, t1)


def test_idle_gaps_by_phase():
    """Gaps named by the innermost phase open at their middle, else by
    the span, else as between programs; longest first."""
    spans = [_span("step", 4, 100, 1000), _span("sync", 4, 1100, 1300)]
    phases = [PhaseRecord("forward", 4, 150, 400),
              PhaseRecord("backward", 4, 400, 800),
              PhaseRecord("observe", 4, 1000, 1100),
              PhaseRecord("allreduce", 4, 1150, 1250),
              PhaseRecord("metrics_allreduce", 4, 1180, 1220)]
    kernels = [(120, 300), (320, 900), (950, 1010), (1060, 1190),
               (1210, 1400)]
    got = phase_gaps.idle_gaps_by_phase(kernels, 0, 1500, spans, phases)
    assert got == [[devtrace.BETWEEN, 1.2e-7], [devtrace.BETWEEN, 1.0e-7],
                   ["step (iteration 4)", 5.0e-8],
                   ["observe (iteration 4)", 5.0e-8],
                   ["forward (iteration 4)", 2.0e-8],
                   ["metrics_allreduce (iteration 4)", 2.0e-8]]
    assert [g[0] for g in phase_gaps.idle_gaps_by_phase(
        kernels, 0, 1500, spans, [])] == [
        devtrace.BETWEEN, devtrace.BETWEEN, "step (iteration 4)",
        devtrace.BETWEEN, "step (iteration 4)", "sync (iteration 4)"]
    assert len(phase_gaps.idle_gaps_by_phase(kernels, 0, 1500, spans,
                                             phases, n=2)) == 2


def test_outside_spans():
    """Host time outside the spans split by the phase open, and the
    device's work meanwhile by kernel."""
    spans = [_span("step", 4, 100, 1000), _span("sync", 4, 1100, 1300)]
    phases = [PhaseRecord("readback", 4, 1000, 1040),
              PhaseRecord("observe", 4, 1300, 1400)]
    kernels = [(900, 1050, "nccl"), (1020, 1060, "add"), (1350, 1600, "mm")]
    got = phase_gaps.outside_spans(kernels, 0, 1500, spans, phases)
    assert got["host_s"] == pytest.approx(400e-9)
    assert got["host_s_by_phase"] == pytest.approx(
        {phase_gaps.NO_PHASE: 260e-9, "observe": 100e-9,
         "readback": 40e-9})
    assert got["device_busy_s"] == pytest.approx(210e-9)
    assert got["device_busy_s_by_kernel"] == [["mm", 1.5e-7],
                                              ["nccl", 5e-8],
                                              ["add", 4e-8]]
