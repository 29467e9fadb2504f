"""Where a training step's, or a served request's, device time goes, by
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile [training flags]
    PYTHONPATH=src python -m repro_torch.launch.profile --warm 1 --window 2 \
        --method qsgd --no-reduced --layers 4
    PYTHONPATH=src python -m repro_torch.launch.profile --serve --no-reduced \
        --batch 4 --seq 2048 --window 8

Training: builds the engine exactly as ``launch/train.py`` does (same
flags), runs ``--warm`` iterations unprofiled, then profiles the next
``--window`` iterations.  ``--serve``: one prefill of ``--batch`` x
``--seq`` tokens with ``use_flash`` set, then ``--window`` decode steps
against f32 caches, each profiled on its own after one unprofiled warm-up
of each.  Each window prints its wall time, the summed device time of its
kernels (and so the card's idle share of the window), the device time by
category, and the kernels with the most device time.  Needs the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import train
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as M

CATEGORIES = (        # first match wins; matched against the kernel name
    ("flash attention", ("flash_fwd",)),
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


def profile_window(run: Callable[[], None], label: str, top: int) -> dict:
    """Profile one call of ``run`` (which must end in a synchronize) and
    print its wall time, device time, idle share and breakdown."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total / 1e3    # us -> ms
    device_ms = sum(kernels.values())
    by_cat = defaultdict(float)
    for name, ms in kernels.items():
        by_cat[category(name)] += ms
    print(f"window: {label} wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} "
          f"idle_share={max(0.0, 1 - device_ms / wall_ms):.4f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:26s} {ms:10.3f} ms  {ms / device_ms:7.2%}")
    print(f"top {top} kernels by device time:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "by_category": dict(by_cat)}


def profile_serving(own: argparse.Namespace,
                    rest: Sequence[str]) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(rest)
    cfg = get_config(args.arch).model
    cfg = reduced(cfg) if args.reduced else cfg
    cfg = dataclasses.replace(cfg, use_flash=True,
                              n_layers=args.layers or cfg.n_layers)
    params = M.init_params(args.seed, cfg)
    if params["embed"].device.type != "cuda":
        raise RuntimeError("profiling reads device time: run on the card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=gen, device="cuda", dtype=torch.int32)
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    caches = M.init_caches(cfg, args.batch, own.window + 1,
                           dtype=torch.float32)

    def run_prefill():
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()

    def run_decode():
        nonlocal caches
        for t in range(own.window):
            _, caches = serve(params, {"tokens": tokens[:, t:t + 1]}, caches)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run_prefill()
        serve(params, {"tokens": tokens[:, :1]}, M.init_caches(
            cfg, args.batch, 1, dtype=torch.float32))
        torch.cuda.synchronize()
        return {"prefill": profile_window(
                    run_prefill, f"prefill {args.batch}x{args.seq}",
                    own.top),
                "decode": profile_window(
                    run_decode, f"{own.window} decode steps, batch "
                    f"{args.batch}", own.top)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--serve", action="store_true")
    own, rest = ap.parse_known_args(argv)
    if own.serve:
        return profile_serving(own, rest)
    args = train.parse_args(rest)
    engine, cfg = train.build_engine(args)
    if engine.backend.device.type != "cuda":
        raise RuntimeError("profiling reads device time: run on the card")
    engine.run(0, own.warm)
    torch.cuda.synchronize()

    def run():
        engine.run(own.warm, own.window)
        torch.cuda.synchronize()

    steps = list(range(own.warm, own.warm + own.window))
    syncs_before = len(engine.history.sync_steps)
    out = profile_window(run, f"steps {steps}", own.top)
    print(f"  syncs at {engine.history.sync_steps[syncs_before:]}")
    return out


if __name__ == "__main__":
    main()
