"""One cell's window with the program's phase recorder, for what the
result line cannot hold: the recorder's cost, and the device's idle gaps
named by phase.

    python3 bench/phase_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --recorder <0|1> --trace <0|1>

from the root of a checkout, on the cell's GPUs (a cell on several cards
starts one process a card, as ``run.py`` does; rank 0 prints).  Set-up
and window are ``run.py``'s; the reference is not run, so nothing is
compared.  ``--recorder 1`` switches the engine's recorder on over the
window (``engine.phases.on``: host times and CUDA event pairs, no
profiler); ``--trace 1`` holds the traced run's profiler and spans over
it (the recorder then records inside the profiler session either way).
Prints one JSON line: the window's ``train_tokens_per_s``; traced, also
the device's ``idle_gaps`` as ``devtrace.py`` names them, the same gaps
named by phase (``idle_gaps_by_phase``), the host's time outside the
benchmark's spans by phase and the device's work meanwhile
(``outside_spans``), each phase's median time an iteration, and the
host's time in a step span before its first phase and after its last
(``step_edges_ms``).
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


class PhaseTracer:
    """``devtrace.Tracer`` that also keeps the device intervals (start,
    end, kernel name) for naming gaps by phase."""

    def __init__(self):
        from bench import devtrace
        self.inner = devtrace.Tracer()
        self.kernels = []

    def start(self) -> None:
        self.inner.start()

    def stop(self, t0_ns, t1_ns, spans) -> None:
        import torch
        prof = self.inner.prof
        prof.__exit__(None, None, None)
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        self.kernels = [(e.start_ns(), e.end_ns(), e.name()) for e in events
                        if e.device_type() == cuda
                        and not e.is_user_annotation()]
        from bench import devtrace
        self.result = devtrace.read_events(events, t0_ns, t1_ns, spans)
        self.t0_ns, self.t1_ns = t0_ns, t1_ns


def phase_medians(records):
    """Each phase's median over the iterations of its sum an iteration:
    {name: [host ms, device ms or None]}."""
    host, dev = defaultdict(lambda: defaultdict(float)), \
        defaultdict(lambda: defaultdict(float))
    for r in records:
        host[r.name][r.k] += r.host_ms
        if r.device_ms is not None:
            dev[r.name][r.k] += r.device_ms
    return {n: [statistics.median(host[n].values()),
                statistics.median(dev[n].values()) if dev[n] else None]
            for n in host}


def step_edges(spans, records):
    """The host's time in each step span before its first phase opens and
    after its last phase closes: [median lead-in ms, median tail ms]."""
    lead, tail = [], []
    for name, _, _, _, a, b in spans:
        inside = [r for r in records if r.t0_ns >= a and r.t1_ns <= b]
        if name == "step" and inside:
            lead.append((min(r.t0_ns for r in inside) - a) / 1e6)
            tail.append((b - max(r.t1_ns for r in inside)) / 1e6)
    return [statistics.median(lead), statistics.median(tail)] if lead \
        else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    from bench.cells import load_cell
    cell = load_cell(args.workload)
    mesh = cell.traffic["backend"] == "mesh"
    if mesh and args.rank is None:
        from bench import run
        return run.launch_script(Path(__file__).resolve(), sys.argv[1:],
                                 cell.chips)
    import torch
    from bench import devtrace, harness, phase_gaps, runner
    rank = args.rank or 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    engine = runner.prepare(cell, args.seed, device)[0]
    spans = tracer = None
    if args.trace:
        devtrace.warm_profiler(device)
        spans, tracer = harness.Spans(engine), PhaseTracer()

    def decide(up: bool) -> bool:
        if not mesh:
            return up
        import torch.distributed as dist
        flag = torch.tensor([int(up)], device=device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    engine.phases.on = bool(args.recorder)
    w = harness.window(engine, args.seconds, spans, decide, tracer)
    engine.phases.on = False
    t = cell.traffic
    out = {"workload": cell.name, "seed": args.seed,
           "recorder": args.recorder, "trace": args.trace,
           "train_tokens_per_s": w["steps"] * t["replicas"] * t["batch"]
           * t["seq"] / w["window_s"],
           "window_s": w["window_s"], "steps": w["steps"]}
    if tracer is not None:
        from repro_torch.runtime import phases
        recs = phases.traced_records()
        ivals = [(a, b) for a, b, _ in tracer.kernels]
        inside = sum(s[3] - s[2] for s in spans.records)
        out.update(
            host_gap_share=100.0 * (1.0 - inside / w["window_s"]),
            device_idle_share=100.0 * (1.0 - tracer.result.busy_s
                                       / tracer.result.window_s),
            idle_gaps=tracer.result.top_gaps(),
            idle_gaps_by_phase=phase_gaps.idle_gaps_by_phase(
                ivals, tracer.t0_ns, tracer.t1_ns, spans.records, recs),
            outside_spans=phase_gaps.outside_spans(
                tracer.kernels, tracer.t0_ns, tracer.t1_ns, spans.records,
                recs),
            span_ms={n: statistics.median(
                (s[3] - s[2]) * 1e3 for s in spans.records if s[0] == n)
                for n in {s[0] for s in spans.records}},
            phase_ms=phase_medians(recs),
            step_edges_ms=step_edges(spans.records, recs))
    if mesh:
        engine.backend.close()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
