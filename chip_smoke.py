#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``, one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version on the card, then drives the
port's paths through the trainer's own entry points — OLMo-1B at its
published width, cut to 4 layers, R = 4 replicas, adamw:

* 3  ADPSGD, 16 steps (the fused mean + sqdev kernel in every sync);
* 3b qsgd_periodic, 16 steps (QSGD-quantized deltas on ADPSGD's schedule:
     sqnorm, quantize, dequantize and mean + sqdev in every quantized sync);
* 3c qsgd, 8 steps (quantized gradients every step);

and times each kernel beside its plain version, a library call and its
bound.  Each path is driven with the launch counts set to 0 just before
it and read just after.

Phases: 1 environment and build; 2 kernels against their plain versions;
3, 3b, 3c the paths; 4 kernel timings.  Any failed check exits non-zero.
The card's ``nvidia-smi`` name and power limit stand on the line before
the ``{"kernels": [...]}`` line, and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before any phase.
"""
from __future__ import annotations

import gc
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

# the paths: OLMo-1B full width, 4 layers, R = 4, adamw
BASE_ARGV = ["--arch", "olmo-1b", "--backend", "vmap", "--no-reduced",
             "--layers", "4", "--replicas", "4", "--batch", "4",
             "--seq", "128", "--warmup-sync", "2", "--p-init", "2",
             "--lr", "4e-4", "--seed", "0"]
MAIN_ARGV = BASE_ARGV + ["--method", "adpsgd", "--steps", "16"]
QSGD_PERIODIC_ARGV = BASE_ARGV + ["--method", "qsgd_periodic",
                                  "--steps", "16"]
QSGD_ARGV = BASE_ARGV + ["--method", "qsgd", "--steps", "8"]
N_LEAVES = 29
BITS = 8
DEVICE = "cuda"

# (R, shape): the reference's kernel-test shapes, then each distinct leaf
# shape of the paths
KERNEL_CASES = [(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3)),
                (4, (2048, 2048)), (4, (2048, 8192)), (4, (8192, 2048)),
                (4, (50304, 2048))]
EMBED_SHAPE = (50304, 2048)
LEAF_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), EMBED_SHAPE]
# (shape, bits): the reference's QSGD kernel-test cases, then the leaves
QSGD_CASES = ([((n,), b) for n in (7, 1000, 1024, 4097) for b in (4, 8)]
              + [((33, 17), 8)] + [(s, BITS) for s in LEAF_SHAPES])
KERNEL_NAMES = ("mean_and_sqdev", "sqnorm", "quantize", "dequantize")


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


def kernel_fns():
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels import qsgd_quant as qq
    return {"mean_and_sqdev": pv.mean_and_sqdev, "sqnorm": qq.sqnorm,
            "quantize": qq.quantize, "dequantize": qq.dequantize}


def reset_counts() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def release() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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


def bound(n_bytes: float, n_ops: float) -> tuple:
    """Least time on the card: the larger of bytes over its memory rate and
    f32 operations over its f32 rate.  Returns (ms, "bytes" |
    "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mean_sqdev_bound(shapes) -> tuple:
    """mean_and_sqdev over stacked buffers of ``shapes``: each input read
    once and the mean written once; about 4 f32 operations per input."""
    n_in = sum(math.prod(s) for s in shapes)
    n_out = sum(math.prod(s[1:]) for s in shapes)
    return bound((n_in + n_out) * 4, 4 * n_in)


def qsgd_bound(name: str, n: int) -> tuple:
    """Per element: sqnorm reads 4 bytes (2 operations); quantize reads x
    and u and writes one int8 level (about 8 operations); dequantize
    reads a level and writes 4 bytes (1 operation)."""
    n_bytes, n_ops = {"sqnorm": (4, 2), "quantize": (9, 8),
                      "dequantize": (5, 1)}[name]
    return bound(n_bytes * n, n_ops * n)


# ------------------------------------------------------------------ phase 2
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
    release()
    return {"max_abs_err": max_mean_err, "max_sq_rel_err": max_sq_rel}


def phase_qsgd_kernels(device) -> dict:
    """sqnorm, quantize and dequantize against their plain versions on the
    card.  sqnorm: rtol 1e-5, or 1e-4 on the embedding (f32 sums in
    another order), and bitwise repeatable.  quantize, given the same norm
    tensor and uniforms, and dequantize: bit-identical.  Also: a zero
    tensor gives norm 0 and levels 0; a level of s + 1 saturates to 127 as
    XLA's cast does; the uniforms drawn on the card equal the CPU's."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import qsgd_quant as qq
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    errs = {"sqnorm": 0.0, "quantize": 0.0, "dequantize": 0.0}
    for shape, bits in QSGD_CASES:
        x = torch.randn(shape, generator=gen, device=device) * 3.0
        u = torch.rand(shape, generator=gen, device=device)
        sq, sq2 = qq.sqnorm(x), qq.sqnorm(x)
        sq_ref = ref.sqnorm_ref(x)
        norm = torch.sqrt(sq)
        lv = qq.quantize(x, u, norm, bits)
        lv_ref, _ = ref.quantize_ref(x, u, bits, norm=norm)
        dq = qq.dequantize(lv, norm, bits)
        dq_ref = ref.dequantize_ref(lv, norm, bits)
        torch.cuda.synchronize()
        sq_abs = abs(float(sq) - float(sq_ref))
        sq_rel = sq_abs / float(sq_ref)
        lv_err = int((lv.to(torch.int32) - lv_ref.to(torch.int32))
                     .abs().max())
        dq_err = float((dq - dq_ref).abs().max())
        tol = 1e-4 if shape == EMBED_SHAPE else 1e-5
        print(f"  qsgd shape={shape} bits={bits}: sq={float(sq):.9e} "
              f"plain={float(sq_ref):.9e} rel={sq_rel:.3e} "
              f"repeat={torch.equal(sq, sq2)} levels_equal="
              f"{torch.equal(lv, lv_ref)} dequant_equal="
              f"{torch.equal(dq, dq_ref)}")
        check(sq_rel <= tol, f"sqnorm rel error {sq_rel} > {tol} at {shape}")
        check(torch.equal(sq, sq2), f"sqnorm not repeatable at {shape}")
        check(lv.dtype == torch.int8 and torch.equal(lv, lv_ref),
              f"levels differ from plain at {shape} bits={bits}")
        check(torch.equal(dq, dq_ref), f"dequantize differs at {shape}")
        errs["sqnorm"] = max(errs["sqnorm"], sq_abs)
        errs["quantize"] = max(errs["quantize"], float(lv_err))
        errs["dequantize"] = max(errs["dequantize"], dq_err)
        del x, u, lv, lv_ref, dq, dq_ref
    z = torch.zeros(128, device=device)
    nz = torch.sqrt(qq.sqnorm(z))
    lz = qq.quantize(z, z, nz)
    check(float(nz) == 0.0 and not lz.any(), "zero tensor: nonzero levels")
    x = torch.tensor([1.5, -1.5, 0.25], device=device)
    near = torch.tensor(1.5 * (1 - 2**-20), device=device)
    lv = qq.quantize(x, torch.zeros(3, device=device), near)
    print(f"  qsgd saturation (|x|/norm·s just above s, u = 0): "
          f"levels={lv.tolist()}")
    check(lv.tolist()[:2] == [127, -128], f"saturation gave {lv.tolist()}")
    key = prng.split(prng.fold_in(prng.prng_key(17), 3), N_LEAVES)[0]
    t0 = time.perf_counter()
    on_card = prng.uniform(key, EMBED_SHAPE, device=device).cpu()
    t1 = time.perf_counter()
    on_cpu = prng.uniform(key, EMBED_SHAPE, device="cpu")
    same = torch.equal(on_card, on_cpu)
    print(f"  uniform {EMBED_SHAPE} card == cpu: {same} "
          f"(card {t1 - t0:.3f} s with copy, cpu "
          f"{time.perf_counter() - t1:.3f} s)")
    check(same, "uniforms on the card differ from the CPU's")
    del on_card, on_cpu
    release()
    return errs


# ------------------------------------------------------------- phases 3-3c
def drive(argv, callbacks=(), wrap=None) -> dict:
    """Build the engine through the training CLI's own setup, time each of
    its programs (host clock between synchronisations), set the launch
    counts to 0, run, and read the counts.  ``wrap(engine, name, program)``
    may wrap a program further (inside the timer)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    args = train.parse_args(argv)
    release()
    torch.cuda.reset_peak_memory_stats()
    engine, cfg = train.build_engine(args, callbacks=list(callbacks))
    n_leaves = len(tree_leaves(engine.W))
    n_params = sum(x.numel() for x in tree_leaves(engine.W)) // args.replicas
    print(f"  model {cfg.name}: d_model={cfg.d_model} n_layers={cfg.n_layers}"
          f" vocab={cfg.vocab_size} params/replica={n_params} "
          f"leaves={n_leaves} R={args.replicas} method={args.method} "
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
        fn = programs[name]
        programs[name] = timed(name, fn if wrap is None
                               else wrap(engine, name, fn))

    reset_counts()
    hist = engine.run()
    launches = read_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    medians = {k: statistics.median(v) for k, v in times.items()}
    print(f"  losses={hist.losses}")
    print(f"  sync_steps={hist.sync_steps} periods={hist.period_history}")
    print(f"  s_k={hist.s_k}")
    for k, v in times.items():
        print(f"  {k}_ms median={medians[k]:.3f} all={v}")
    print(f"  max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    print(f"  launches={launches} n_syncs={hist.n_syncs}")
    check(n_leaves == N_LEAVES, f"{n_leaves} leaves, expected {N_LEAVES}")
    check(len(hist.losses) == args.steps, "not every step reported a loss")
    check(all(math.isfinite(x) for x in hist.losses), "non-finite loss")
    check(all(math.isfinite(x) for x in hist.s_k), "non-finite S_k")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(engine.W)),
          "non-finite final parameters")
    return {"engine": engine, "hist": hist, "launches": launches,
            "ms": medians, "peak_bytes": peak, "n_syncs": hist.n_syncs}


def phase_main_path() -> dict:
    """ADPSGD; each sync's S_k against the plain version on the same
    pre-sync W."""
    import torch
    from repro_torch.kernels.ref import mean_and_sqdev_ref
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

    probe = PlainProbe()
    out = drive(MAIN_ARGV, callbacks=[probe])
    hist, launches = out.pop("hist"), out["launches"]
    print(f"  s_k_plain={[probe.plain.get(k) for k in hist.sync_steps]}")
    check(hist.n_syncs >= 4, f"only {hist.n_syncs} syncs")
    check(launches == dict(mean_and_sqdev=N_LEAVES * hist.n_syncs, sqnorm=0,
                           quantize=0, dequantize=0),
          f"launches {launches} != {N_LEAVES} x {hist.n_syncs} mean_sqdev")
    rels = [abs(s - probe.plain[k]) / abs(probe.plain[k])
            for k, s in zip(hist.sync_steps, hist.s_k)]
    print(f"  s_k rel err kernel vs plain per sync={rels}")
    check(rels[-1] <= 1e-4, f"last sync S_k rel err {rels[-1]} > 1e-4")
    out.pop("engine")
    return out


def phase_qsgd_periodic() -> dict:
    """qsgd_periodic: the seeding sync costs 29 mean_and_sqdev launches,
    each later sync 29 x 4 of sqnorm, quantize and dequantize plus 29 of
    mean_and_sqdev.  At the last sync the kernel route's S_k is held
    against the plain route's on the same W, anchor and key (rtol 1e-4:
    the norms differ by rounding, which can flip a level where u is
    within an ulp of its fraction)."""
    import torch
    from repro_torch.backends import VmapBackend
    from repro_torch.core import qsgd as Q
    from repro_torch.core import prng
    from repro_torch.tree import tree_leaves, tree_map

    snap = {}

    def wrap(engine, name, fn):
        if name != "sync":
            return fn

        def sync(W, opt_state, batch, lr, key):
            anchor = engine.strategy._anchor
            if anchor is not None:            # a quantized sync: keep inputs
                snap.clear()
                snap.update(W=tree_map(torch.clone, W),
                            anchor=tree_map(torch.clone, anchor), key=key)
            return fn(W, opt_state, batch, lr, key)
        return sync

    out = drive(QSGD_PERIODIC_ARGV, wrap=wrap)
    engine, hist = out.pop("engine"), out.pop("hist")
    n = hist.n_syncs
    q = N_LEAVES * 4 * (n - 1)
    want = dict(mean_and_sqdev=N_LEAVES * n, sqnorm=q, quantize=q,
                dequantize=q)
    check(n >= 4, f"only {n} syncs")
    check(out["launches"] == want, f"launches {out['launches']} != {want}")
    s_k_kernel = hist.s_k[-1]
    del engine
    release()

    with torch.no_grad():
        W, anchor, key = snap["W"], snap["anchor"], snap["key"]
        leaves, anchors = tree_leaves(W), tree_leaves(anchor)
        R = leaves[0].shape[0]
        leaf_keys = [prng.split(k, len(leaves))
                     for k in Q.replica_keys(key, range(R))]
        flips, total, norm_rel = 0, 0, 0.0
        for i, (w, a) in enumerate(zip(leaves, anchors)):
            for r in range(R):
                d = w[r] - a
                lk, nk = Q.quantize(d, leaf_keys[r][i], BITS, use_kernel=True)
                lp, np_ = Q.quantize(d, leaf_keys[r][i], BITS,
                                     use_kernel=False)
                flips += int((lk != lp).sum())
                total += lk.numel()
                if float(np_) > 0:
                    norm_rel = max(norm_rel, abs(float(nk) - float(np_))
                                   / float(np_))
                del d, lk, lp
        plain = VmapBackend(use_kernel=False, device=leaves[0].device)
        _, _, s_k_plain = plain.quantized_all_mean(BITS)(W, anchor, key)
        s_k_plain = float(s_k_plain)
    rel = abs(s_k_kernel - s_k_plain) / abs(s_k_plain)
    print(f"  last sync: s_k kernel={s_k_kernel!r} plain={s_k_plain!r} "
          f"rel={rel:.3e}; levels differing kernel vs plain: {flips} of "
          f"{total}; max norm rel diff {norm_rel:.3e}")
    check(rel <= 1e-4, f"last quantized sync S_k rel err {rel} > 1e-4")
    snap.clear()
    del W, anchor, leaves, anchors
    release()
    out.update(s_k_rel=rel, level_flips=flips)
    return out


def phase_qsgd() -> dict:
    """qsgd: 8 steps; the replicas stay bit-identical after every step
    (max |W_r - W_0| = 0 on every leaf); launches = 8 x 4 x 29 of each
    QSGD kernel."""
    import torch
    from repro_torch.runtime.engine import Callback
    from repro_torch.tree import tree_leaves

    class SameReplicas(Callback):
        def __init__(self):
            self.max_diff = []

        def on_step_end(self, engine, k, metrics):
            self.max_diff.append(max(
                float((x - x[:1]).abs().max()) for x in tree_leaves(engine.W)))

    probe = SameReplicas()
    out = drive(QSGD_ARGV, callbacks=[probe])
    engine, hist = out.pop("engine"), out.pop("hist")
    steps = len(hist.losses)
    q = steps * 4 * N_LEAVES
    want = dict(mean_and_sqdev=0, sqnorm=q, quantize=q, dequantize=q)
    print(f"  max |W_r - W_0| after each step: {probe.max_diff}")
    check(steps == 8 and hist.n_syncs == 8, f"{steps} steps, "
          f"{hist.n_syncs} communication events")
    check(all(d == 0.0 for d in probe.max_diff), "replicas diverged")
    check(out["launches"] == want, f"launches {out['launches']} != {want}")
    out["W"] = engine.W
    del engine
    return out


# ------------------------------------------------------------------ phase 4
def phase_timing(W) -> dict:
    """mean_and_sqdev: kernel, plain version and torch.var_mean (a
    yardstick the port never calls) on the embedding leaf and on all
    leaves of one sync."""
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
        row["bound_ms"], row["bound_by"] = mean_sqdev_bound(
            [tuple(x.shape) for x in group])
        out[label] = row
        print(f"  timing mean_and_sqdev {label} ({len(group)} leaves): "
              + " ".join(f"{k}={v}" for k, v in row.items()))
    return out


def phase_qsgd_timing(W) -> dict:
    """sqnorm, quantize and dequantize: kernel, plain version and, where
    one PyTorch call computes the same function, that call (``torch.dot``
    of the flat view with itself; ``torch.mul(levels, norm / s)``; none
    for quantize), on one replica of the embedding leaf and over one whole
    exchange (29 leaves x 4 replicas); and the uniform generator's time
    per exchange, under the exchange's own keys."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import qsgd_quant as qq
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(W)
    R = leaves[0].shape[0]
    s = ref.qsgd_scale(BITS)
    gen = torch.Generator(device=leaves[0].device)
    gen.manual_seed(2)
    items = []
    for w in leaves:
        for r in range(R):
            x = w[r]
            u = torch.rand(x.shape, generator=gen, device=x.device)
            norm = torch.sqrt(qq.sqnorm(x))
            items.append((x, u, norm, qq.quantize(x, u, norm, BITS)))
    embed = max(items, key=lambda it: it[0].numel())
    fns = {
        "sqnorm": (lambda x, u, n, lv: qq.sqnorm(x),
                   lambda x, u, n, lv: ref.sqnorm_ref(x),
                   lambda x, u, n, lv: torch.dot(x.view(-1), x.view(-1))),
        "quantize": (lambda x, u, n, lv: qq.quantize(x, u, n, BITS),
                     lambda x, u, n, lv: ref.quantize_ref(
                         x, u, BITS, norm=n)[0],
                     None),
        "dequantize": (lambda x, u, n, lv: qq.dequantize(lv, n, BITS),
                       lambda x, u, n, lv: ref.dequantize_ref(lv, n, BITS),
                       lambda x, u, n, lv: torch.mul(lv, n / s)),
    }
    out = {}
    for shape in sorted({tuple(it[0].shape) for it in items}):
        it = next(it for it in items if tuple(it[0].shape) == shape)
        n_el = it[0].numel()
        print(f"  timing per call, one {shape} tensor: " + " ".join(
            f"{name}={cuda_ms(lambda: fns[name][0](*it), 20):.4f}ms"
            f"(bound {qsgd_bound(name, n_el)[0]:.4f})" for name in fns))
    for label, group, iters in (("embed", [embed], 20),
                                ("exchange", items, 5)):
        n_el = sum(it[0].numel() for it in group)
        for name, (kernel, plain, library) in fns.items():
            def over(fn, group=group):
                return lambda: [fn(*it) for it in group]
            row = {"ms": cuda_ms(over(kernel), iters),
                   "plain_ms": cuda_ms(over(plain), iters),
                   "library_ms": (cuda_ms(over(library), iters)
                                  if library is not None else None)}
            row["bound_ms"], row["bound_by"] = qsgd_bound(name, n_el)
            out[(name, label)] = row
            print(f"  timing {name} {label} ({len(group)} tensors, "
                  f"{n_el} elements): "
                  + " ".join(f"{k}={v}" for k, v in row.items()))
    del items, embed
    release()
    keys = [prng.split(k, len(leaves))
            for k in prng.replica_keys(prng.prng_key(17), range(R))]
    uniform_ms = cuda_ms(lambda: [
        prng.uniform(keys[r][i], w.shape[1:], device=w.device)
        for i, w in enumerate(leaves) for r in range(R)], 2)
    print(f"  timing uniform generator per exchange "
          f"({len(leaves)} leaves x {R} replicas): {uniform_ms} ms")
    out["uniform_ms"] = uniform_ms
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels import qsgd_quant as qq

    device = torch.device(DEVICE)
    card = card_line()
    print(f"phase 1: environment  card: {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build(pv.SOURCE, qq.SOURCE)
    print(f"  built {[build.library_path(s).name for s in (pv.SOURCE, qq.SOURCE)]}"
          f" in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, report in reports.items():
        for line in report.splitlines():
            print(f"  nvcc {name}: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("phase 2: kernels against their plain versions")
    errs = phase_kernels(device)
    qerrs = phase_qsgd_kernels(device)

    print("phase 3: ADPSGD, OLMo-1B full width, 4 layers, R=4")
    main_path = phase_main_path()
    release()
    print("phase 3b: qsgd_periodic, OLMo-1B full width, 4 layers, R=4")
    qp = phase_qsgd_periodic()
    release()
    print("phase 3c: qsgd, OLMo-1B full width, 4 layers, R=4")
    qs = phase_qsgd()

    print(f"phase 4: kernel timings  card: {card}")
    W = qs.pop("W")
    timing = phase_timing(W)
    qtiming = phase_qsgd_timing(W)
    del W
    release()

    paths = {"adpsgd": main_path, "qsgd_periodic": qp, "qsgd": qs}
    launches = {k: sum(p["launches"][k] for p in paths.values())
                for k in KERNEL_NAMES}
    print("launches by path: " + json.dumps(
        {name: p["launches"] for name, p in paths.items()}))
    sync = timing["sync"]
    kernels = [{
        "name": "mean_and_sqdev", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mean_sqdev.cu",
        "replaces": "src/repro/kernels/param_variance.py:47",
        "launches": launches["mean_and_sqdev"],
        "max_abs_err": errs["max_abs_err"],
        "ms": sync["ms"], "plain_ms": sync["plain_ms"],
        "bound_ms": sync["bound_ms"], "bound_by": sync["bound_by"],
        "library_ms": sync["library_ms"],
    }]
    for name, line in (("sqnorm", 59), ("quantize", 80), ("dequantize", 101)):
        row = qtiming[(name, "exchange")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qsgd_quant.cu",
            "replaces": f"src/repro/kernels/qsgd_quant.py:{line}",
            "launches": launches[name], "max_abs_err": qerrs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print("summary: " + json.dumps({
        name: {k: p[k] for k in ("ms", "peak_bytes", "n_syncs")}
        for name, p in paths.items()}))
    print(f"summary: mean_and_sqdev embed={timing['embed']} "
          f"uniform_ms_per_exchange={qtiming['uniform_ms']} "
          f"qsgd_periodic last-sync s_k_rel={qp['s_k_rel']} "
          f"level_flips={qp['level_flips']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
