"""One process's part of a run: set-up, window, and on rank 0 the
reference, the metrics and the result line (``run.py`` prints it)."""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from bench import correct, devtrace, harness, inputs
from bench.cells import Cell, reader
from bench.reference import train as reference


PHASES: Dict[str, float] = {}     # set-up's parts, seconds (stderr)


class GcLog:
    """Python's garbage collections while the window runs (host pauses
    the device waits through), from ``gc.callbacks``."""

    def __init__(self):
        import gc
        self.events, self._t = [], {}
        self._gc = gc
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t[info["generation"]] = time.perf_counter()
        elif info["generation"] in self._t:
            self.events.append((info["generation"], time.perf_counter()
                                - self._t.pop(info["generation"])))

    def close(self):
        self._gc.callbacks.remove(self._on)

    def describe(self) -> str:
        by = {}
        for g, s in self.events:
            n, t = by.get(g, (0, 0.0))
            by[g] = (n + 1, t + s)
        return "gc " + ", ".join(f"gen{g} {n}x {t:.3f} s"
                                  for g, (n, t) in sorted(by.items()))


def _gather(obj, world: int):
    import torch.distributed as dist
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def prepare(cell: Cell, seed: int, device, strict: bool = True):
    """Inputs, engine and warm-up: (engine, the initial leaves on the
    host, the tree's skeleton, the token batches, the program's
    readings)."""
    t = cell.traffic
    clock = [time.time()]

    def lap(name):
        PHASES[name] = round(time.time() - clock[0], 3)
        clock[0] = time.time()

    cfg = harness.port_config(cell, strict=strict)
    lap("import_port")
    params0 = inputs.make_params(cell.config, seed, device)
    harness.check_layout(params0, cfg)
    tokens = inputs.make_tokens(cell.config["vocab_size"], t["data_steps"],
                                t["replicas"], t["batch"], t["seq"], seed,
                                device)
    harness.sync()
    lap("inputs")
    engine = harness.build_engine(cell, cfg, params0, tokens, seed, device)
    harness.sync()
    lap("engine")
    params_host = [x.to("cpu", copy=True) for x in reference.leaves(params0)]
    skeleton = reference.rebuild(params0, [
        torch.empty(0, device="meta") for _ in params_host])
    del params0
    lap("host_copy")
    readings = harness.warm_up(engine, params_host,
                               cell.config["training"]["adam_b1"])
    harness.sync()
    lap("warm_up")
    return engine, params_host, skeleton, tokens, readings


def program_readings(parts) -> Dict[str, list]:
    """The job's readings from every process's (in rank order)."""
    prog = {"losses": parts[0].losses, "s_k": parts[0].s_k,
            "grad_norms": [], "delta_norms": []}
    for r in parts:
        prog["grad_norms"] += r.grad_norms
        prog["delta_norms"] += r.delta_norms
    return prog


def run(cell: Cell, *, seed: int, seconds: float, trace: bool,
        t_start: float, rank: int = 0, device=None, strict: bool = True
        ) -> Tuple[Optional[Dict], List[str]]:
    """Returns (the result line's object, the lines for standard error)
    on rank 0, (None, []) on the other ranks."""
    mesh = cell.traffic["backend"] == "mesh"
    world = cell.chips if mesh else 1
    if device is None:
        device = torch.device("cuda", rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(1)
    t = cell.traffic
    engine, params_host, skeleton, tokens, readings = prepare(
        cell, seed, device, strict)
    spans = tracer = None
    if trace:
        devtrace.warm_profiler(device)
        spans, tracer = harness.Spans(engine), devtrace.Tracer()

    def decide(up: bool) -> bool:
        if not mesh:
            return up
        import torch.distributed as dist
        flag = torch.tensor([int(up)], device=device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    harness.sync()
    setup_s = time.time() - t_start
    gc_log = GcLog()
    w = harness.window(engine, seconds, spans, decide, tracer)
    gc_log.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    stats = (torch.cuda.memory_stats(device) if device.type == "cuda"
             else {})
    dtrace = tracer.result if tracer is not None else None
    harness.free_program(engine)
    mine = {"readings": readings, "peak": peak,
            "busy": dtrace.busy_s if dtrace else None,
            "traced": dtrace.window_s if dtrace else None}
    if mesh:
        everyone = _gather(mine, world)
        engine.backend.close()
    else:
        everyone = [mine]
    del engine
    if rank != 0:
        return None, []

    prog = program_readings([p["readings"] for p in everyone])
    t_ref = time.time()
    ref = reference.follow(cell.config, t, skeleton, params_host, tokens,
                           seed % harness.ENGINE_SEED_MOD,
                           steps=harness.FOLLOWED)
    ref_s = time.time() - t_ref
    values = correct.gaps(prog, ref)
    ok, checks = correct.verdict(values, cell.limits)

    run_ = harness.Run(
        cell=cell, chips=world, setup_s=setup_s, window_s=w["window_s"],
        steps=w["steps"], syncs=w["syncs"],
        tokens=w["steps"] * t["replicas"] * t["batch"] * t["seq"],
        peak_bytes=max(p["peak"] for p in everyone),
        flops_per_step=harness.flops_per_step(cell),
        leaf_shapes=[tuple(x.shape) for x in params_host],
        spans=spans.records if spans else [], trace=dtrace)
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for v in w["losses"] if not math.isfinite(v))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world, "memory_peak_bytes": run_.peak_bytes}
    result = {"correct": ok and failed == 0, "attempted": w["steps"],
              "failed": failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = sum(p["busy"] for p in everyone) / world
        dev["window_s"] = sum(p["traced"] for p in everyone) / world
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.top_gaps()}
    result["checks"] = checks
    notes = [harness.describe_window(w, cell),
             f"losses: followed {readings.losses} reference "
             f"{ref['losses']}; window first/last "
             f"{w['losses'][:1]} {w['losses'][-1:]}",
             f"set-up {setup_s:.3f} s {PHASES}, reference {ref_s:.3f} s, "
             f"peak {run_.peak_bytes} B",
             f"iterations end at {[round(x, 3) for x in w['iteration_ends_s']]}"
             f" s; in the window: {gc_log.describe()}; allocator retries "
             f"{stats.get('num_alloc_retries')}, reserved peak "
             f"{stats.get('reserved_bytes.all.peak')} B"] + correct.lines(checks)
    return result, notes
