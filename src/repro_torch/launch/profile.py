"""Where a training step's device time goes, by ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile [training flags]
    PYTHONPATH=src python -m repro_torch.launch.profile --warm 1 --window 2 \
        --method qsgd --no-reduced --layers 4

Builds the engine exactly as ``launch/train.py`` does (same flags), runs
``--warm`` iterations unprofiled, then profiles the next ``--window``
iterations and prints: the window's wall time, the summed device time of
its kernels (and so the card's idle share of the window), the device time
by category, and the kernels with the most device time.  Needs the card.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Optional, Sequence

import torch

from repro_torch.launch import train

CATEGORIES = (        # first match wins; matched against the kernel name
    ("mean_sqdev", ("mean_sqdev",)),
    ("qsgd kernels", ("sqnorm_pass", "quantize_kernel")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduction", ("reduce",)),
    ("index / gather / scatter", ("index", "gather", "scatter", "embedding")),
    ("copy / cast", ("copy", "cast", "fill", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "foreach")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    own, rest = ap.parse_known_args(argv)
    args = train.parse_args(rest)
    engine, cfg = train.build_engine(args)
    if engine.backend.device.type != "cuda":
        raise RuntimeError("profiling reads device time: run on the card")
    engine.run(0, own.warm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run(own.warm, own.window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total / 1e3    # us -> ms
    device_ms = sum(kernels.values())
    by_cat = defaultdict(float)
    for name, ms in kernels.items():
        by_cat[category(name)] += ms
    steps = list(range(own.warm, own.warm + own.window))
    syncs = [k for k in engine.history.sync_steps if k in steps]
    print(f"window: steps {steps} (syncs at {syncs}) wall_ms={wall_ms:.3f} "
          f"device_ms={device_ms:.3f} idle_share="
          f"{max(0.0, 1 - device_ms / wall_ms):.4f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:26s} {ms:10.3f} ms  {ms / device_ms:7.2%}")
    print(f"top {own.top} kernels by device time:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:own.top]:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "by_category": dict(by_cat)}


if __name__ == "__main__":
    main()
