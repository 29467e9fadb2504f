#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds each kernel against its plain PyTorch version on the
card, then drives the port's main path — ADPSGD training of OLMo-1B at its
published width, cut to 4 layers, R = 4 replicas, adamw, 16 steps —
through the trainer's own entry points, and times each kernel beside its
plain version, a library call and its bound.

Phases: 1 environment and build; 2 kernels against their plain versions;
3 the main path; 4 kernel timings.  Any failed check exits non-zero.
The card's ``nvidia-smi`` name and power limit stand on the line before
the ``{"kernels": [...]}`` line, and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before any phase.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores

# the main path: OLMo-1B full width, 4 layers, R = 4, adamw, ADPSGD
MAIN_ARGV = ["--arch", "olmo-1b", "--method", "adpsgd", "--backend", "vmap",
             "--no-reduced", "--layers", "4", "--replicas", "4",
             "--batch", "4", "--seq", "128", "--steps", "16",
             "--warmup-sync", "2", "--p-init", "2", "--seed", "0"]

# (R, shape): the reference's kernel-test shapes, then each distinct leaf
# shape of the main path
KERNEL_CASES = [(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3)),
                (4, (2048, 2048)), (4, (2048, 8192)), (4, (8192, 2048)),
                (4, (50304, 2048))]
EMBED_SHAPE = (50304, 2048)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(shapes) -> tuple:
    """Least time for mean_and_sqdev over stacked buffers of ``shapes``:
    each input read once and the mean written once, against the card's
    memory rate; about 4 f32 operations per input element against its f32
    rate.  Returns (ms, "bytes" | "operations")."""
    n_in = sum(math.prod(s) for s in shapes)
    n_out = sum(math.prod(s[1:]) for s in shapes)
    t_bytes = (n_in + n_out) * 4 / HBM_BYTES_PER_S
    t_ops = 4 * n_in / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(device) -> dict:
    """The CUDA mean_and_sqdev against its plain version on the card, and
    run twice for a bitwise repeat.  Tolerances: mean atol 1e-6 (one f32
    rounding of the same four-term sum); sq rtol 1e-5, or 1e-4 on the
    embedding, where the order of summation over 4e8 terms differs."""
    import torch
    from repro_torch.kernels.param_variance import mean_and_sqdev
    from repro_torch.kernels.ref import mean_and_sqdev_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    max_mean_err, max_sq_rel = 0.0, 0.0
    for R, shape in KERNEL_CASES:
        w = torch.randn((R, *shape), generator=gen, device=device)
        m, sq = mean_and_sqdev(w)
        m2, sq2 = mean_and_sqdev(w)
        m_ref, sq_ref = mean_and_sqdev_ref(w)
        torch.cuda.synchronize()
        mean_err = float((m - m_ref).abs().max())
        sq_rel = abs(float(sq) - float(sq_ref)) / abs(float(sq_ref))
        tol = 1e-4 if shape == EMBED_SHAPE else 1e-5
        print(f"  kernel R={R} shape={shape}: sq={float(sq):.9e} "
              f"plain={float(sq_ref):.9e} rel={sq_rel:.3e} "
              f"mean_abs_err={mean_err:.3e} bitwise_repeat="
              f"{torch.equal(sq, sq2) and torch.equal(m, m2)}")
        check(m.shape == shape, f"mean shape {tuple(m.shape)} != {shape}")
        check(mean_err <= 1e-6, f"mean error {mean_err} at {shape}")
        check(sq_rel <= tol, f"sq rel error {sq_rel} > {tol} at {shape}")
        check(torch.equal(sq, sq2) and torch.equal(m, m2),
              f"not bitwise repeatable at {shape}")
        max_mean_err = max(max_mean_err, mean_err)
        max_sq_rel = max(max_sq_rel, sq_rel)
        del w, m, m2, m_ref
    same = torch.randn(50, generator=gen, device=device).expand(8, 50)
    _, sq = mean_and_sqdev(same.contiguous())
    print(f"  kernel identical replicas: sq={float(sq):.3e}")
    check(float(sq) < 1e-10, "identical replicas give sq >= 1e-10")
    torch.cuda.empty_cache()
    return {"max_abs_err": max_mean_err, "max_sq_rel_err": max_sq_rel}


def phase_main_path(argv) -> dict:
    """Train through the training CLI's own engine setup; time the step and sync
    programs; compare each sync's S_k with the plain version on the same
    pre-sync W."""
    import torch
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels.ref import mean_and_sqdev_ref
    from repro_torch.launch import train
    from repro_torch.runtime.engine import Callback
    from repro_torch.tree import tree_leaves

    class PlainProbe(Callback):
        """Plain S_k of the W the sync is about to average."""

        def __init__(self):
            self.plain = {}

        def on_step_end(self, engine, k, metrics):
            if engine.strategy.controller.sync_steps[-1:] == [k]:
                with torch.no_grad():
                    leaves = tree_leaves(engine.W)
                    self.plain[k] = float(
                        sum(mean_and_sqdev_ref(x)[1] for x in leaves)
                        / leaves[0].shape[0])

    args = train.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    probe = PlainProbe()
    engine, cfg = train.build_engine(args, callbacks=[probe])
    n_leaves = len(tree_leaves(engine.W))
    n_params = sum(x.numel() for x in tree_leaves(engine.W)) // args.replicas
    print(f"  model {cfg.name}: d_model={cfg.d_model} n_layers={cfg.n_layers}"
          f" vocab={cfg.vocab_size} params/replica={n_params} "
          f"leaves={n_leaves} R={args.replicas} "
          f"backend={engine.backend.describe()}")

    times = {}

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return run

    programs = engine.strategy.programs
    for name in list(programs):
        programs[name] = timed(name, programs[name])

    pv.mean_and_sqdev.launches = 0
    hist = engine.run()
    launches = pv.mean_and_sqdev.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    print(f"  losses={hist.losses}")
    print(f"  sync_steps={hist.sync_steps} periods={hist.period_history}")
    print(f"  s_k={hist.s_k}")
    print(f"  s_k_plain={[probe.plain.get(k) for k in hist.sync_steps]}")
    step_ms = statistics.median(times["step"])
    sync_ms = statistics.median(times["sync"])
    print(f"  step_ms median={step_ms:.3f} all={times['step']}")
    print(f"  sync_ms median={sync_ms:.3f} all={times['sync']}")
    print(f"  max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    print(f"  kernel launches={launches} n_syncs={hist.n_syncs} "
          f"leaves={n_leaves}")

    check(len(hist.losses) == args.steps, "not every step reported a loss")
    check(all(math.isfinite(x) for x in hist.losses), "non-finite loss")
    check(all(math.isfinite(x) for x in hist.s_k), "non-finite S_k")
    check(hist.n_syncs >= 4, f"only {hist.n_syncs} syncs")
    check(n_leaves == 29, f"{n_leaves} leaves, expected 29")
    check(launches == n_leaves * hist.n_syncs,
          f"{launches} kernel launches != {n_leaves} x {hist.n_syncs}")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(engine.W)),
          "non-finite final parameters")
    rels = [abs(s - probe.plain[k]) / abs(probe.plain[k])
            for k, s in zip(hist.sync_steps, hist.s_k)]
    print(f"  s_k rel err kernel vs plain per sync={rels}")
    check(rels[-1] <= 1e-4, f"last sync S_k rel err {rels[-1]} > 1e-4")
    return {"W": engine.W, "launches": launches, "n_syncs": hist.n_syncs,
            "step_ms": step_ms, "sync_ms": sync_ms, "peak_bytes": peak}


def phase_timing(W) -> dict:
    """Kernel, plain version and torch.var_mean (a yardstick the port never
    calls) on the embedding leaf and on all leaves of one sync."""
    import torch
    from repro_torch.kernels.param_variance import mean_and_sqdev
    from repro_torch.kernels.ref import mean_and_sqdev_ref
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(W)
    embed = max(leaves, key=lambda x: x.numel())
    out = {}
    for label, group, iters in (("embed", [embed], 20),
                                ("sync", leaves, 10)):
        def over(fn, group=group):
            return lambda: [fn(x) for x in group]
        row = {
            "ms": cuda_ms(over(mean_and_sqdev), iters),
            "plain_ms": cuda_ms(over(mean_and_sqdev_ref), iters),
            "library_ms": cuda_ms(over(lambda x: torch.var_mean(
                x, dim=0, correction=0)), iters),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(
            [tuple(x.shape) for x in group])
        out[label] = row
        print(f"  timing {label} ({len(group)} leaves): "
              + " ".join(f"{k}={v}" for k, v in row.items()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import param_variance as pv

    device = torch.device("cuda")
    card = card_line()
    print(f"phase 1: environment  card: {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = pv.build()
    print(f"  built {pv.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        print(f"  nvcc: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("phase 2: kernels against their plain versions")
    errs = phase_kernels(device)

    print("phase 3: main path (ADPSGD, OLMo-1B full width, 4 layers, R=4)")
    path = phase_main_path(MAIN_ARGV)

    print(f"phase 4: kernel timings  card: {card}")
    timing = phase_timing(path.pop("W"))
    torch.cuda.empty_cache()

    sync = timing["sync"]
    kernels = [{
        "name": "mean_and_sqdev", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mean_sqdev.cu",
        "replaces": "src/repro/kernels/param_variance.py:47",
        "launches": path["launches"],
        "max_abs_err": errs["max_abs_err"],
        "ms": sync["ms"], "plain_ms": sync["plain_ms"],
        "bound_ms": sync["bound_ms"], "bound_by": sync["bound_by"],
        "library_ms": sync["library_ms"],
    }]
    print(f"summary: step_ms={path['step_ms']} sync_ms={path['sync_ms']} "
          f"peak_bytes={path['peak_bytes']} n_syncs={path['n_syncs']} "
          f"embed={timing['embed']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
