#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --tp-multi-gpu   # a host of 2 or 4 GPUs
    python3 chip_smoke.py --cpu-uniform    # the helper: phase 2's CPU draw
    python3 chip_smoke.py --remat-peaks    # the helper: phase 17's meta peaks
    python3 chip_smoke.py --cnn PATH       # phase 8 in its own process

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``, one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version on the card, then drives the
port's paths through the trainer's own entry points — OLMo-1B at its
published width, cut to 4 layers, R = 4 replicas, adamw:

* 3  ADPSGD, 16 steps (the fused mean + sqdev kernel in every sync, one
     launch over all 29 leaves);
* 3b qsgd_periodic, 16 steps (QSGD-quantized deltas on ADPSGD's schedule:
     sqnorm once per leaf over its 4 deltas, quantize, dequantize and mean
     + sqdev in every quantized sync);
* 3c qsgd, 8 steps (quantized gradients every step; sqnorm once per
     replica over its 29 leaves);

then serves OLMo-1B at its published width and all 16 layers through the
server's entry points (phase 5: a prefill step with the flash-attention
kernel, its plain and f32 counterparts, and greedy decoding with KV
caches), and times each kernel beside its plain version, a library call
and its bound.  Phase 6 reruns phase 3 under the telemetry clocks
(``--net 10gbps``, ``--net real``, ``--net real --wallclock-sample-every
4``); phase 7 runs the last three strategies on the same model
(``hier_adpsgd``, ``dasgd``, ``adacomm`` on time blocks); phase 8 runs
the paper's CNN experiment (``benchmarks/common.py``'s settings, built
from the port's modules, from the reference's init) for all nine
strategies at 10 and 100 Gbps beside ``BENCH_engine.json``, holding its
loss and gradients on the card against the CPU route and every sync's
S_k against the plain route, and FULLSGD's final W bitwise equal under
both clocks.  Phase 9 checkpoints phase 3's run after 8 steps and phase
7's dasgd run with a correction in flight, resumes each through the
training CLI's setup and ``TrainerEngine.load_state``, and holds both to
the uninterrupted runs bit for bit; phase 10 serves MiniCPM-2B, GLM4-9B
and Qwen2.5-14B at full width and depth as phase 5 serves OLMo-1B.  Phase
11 trains DeepSeek-V2-Lite (MLA, routed and shared experts, a dense first
layer) at full width, cut to 2 layers, with ADPSGD at R = 4 (the fused
mean + sqdev kernel in every sync, at the expert leaves' shapes); phase 12
serves DeepSeek-V2-Lite at full width and depth and Mixtral-8x22B at full
width, cut to 4 of 56 layers (neither reaches flash attention, in the
reference as here).  Phase 13 trains Qwen2-VL-2B (momentum) and
Whisper-medium (adamw, 1500 seeded frames a sample) at full width and
depth with ADPSGD at R = 4, and serves both whole (Qwen2-VL's prefill
with a 64-patch vision prefix, Whisper's over 1500 frames, both through
flash; Whisper's encoder and cross attention bypass it, as in the
reference).  Phase 14 trains xLSTM-350M at full width and depth (R = 4,
adamw) and Jamba-1.5-Large at full width cut to its first layer (Mamba
and a dense MLP, R = 2) with ADPSGD, and serves xLSTM-350M whole and
Jamba cut to layers 0-4 (four Mamba layers, two of them with 16 experts,
and the attention layer, through flash) with bf16 parameters; the
recurrent mixers (the selective scan, the mLSTM's chunks, the sLSTM's
steps) run as plain PyTorch, in the reference as here.  Phase 15, run
after phase 9 while phases 3, 3b and 7's final W are still on the host,
starts one NCCL rank in this process and trains phase 3's ADPSGD, phase
3b's qsgd_periodic and phase 7's dasgd and hier_adpsgd with ``--backend
mesh`` (``backends/mesh.py``): each history and final W must equal the
vmap run's bit for bit (at world 1 the chunk is every replica), with the
``torch.distributed`` calls of every program counted (a local step: its
metrics mean alone; a sync: 2 all-reduces, also on an 8-leaf tree; a
quantized sync: one all_gather of R_local × ``payload_bytes``), the
mean + sqdev kernel in its modes mean and sync_to (and delta_to for
DaSGD; both divide the all-reduced sum by the world size as they read
it), and the mesh sync timed beside the vmap one; then the training
CLI runs 4 steps under ``torch.distributed.run --standalone
--nproc-per-node 1``.  Phase 15b reruns phase 3's ADPSGD, 3b's
qsgd_periodic and 7's dasgd under the mesh's ``replica_tp`` placement
with a model axis of 1 (every replica's forward and backward on
DTensors over a one-rank model mesh): each history and final W bitwise
the vmap run's, the collectives of every program by group (data / model
/ world) and DTensor's own in the first step, the local step's and the
sync's ms beside phase 15's and vmap's, the peak memory, the functions
run on whole operands; then the CLI with the placement, and (on a host
of 2 GPUs or more; ``--tp-multi-gpu`` runs this part alone) the CLI with
a model axis of 2 held to phase 3's run.  Phase 16, after 15b, holds
the dry run's counts to the card: phase 3's local and sync steps
(``launch/steps.py::make_steps``) and phase 5's flash prefill counted on
meta tensors (``launch/dryrun.py::analyze``) against one real run of
each (FLOPs equal ``FlopCounterMode``'s, argument bytes the engine's
tensors', the predicted peak within 15 % of ``max_memory_allocated``,
the recorded kernel calls the launches), prints the roofline share of
the measured step, sync and prefill against both rooflines (the least
traffic, and the eager ops' own), and collects ``python -m
repro_torch.launch.dryrun`` on the fake 32 x 8 mesh for OLMo-1B and
Mixtral-8x22B at train_4k.  Phase 17 trains OLMo-1B at full
width and all 16 layers at 2 x 4096 tokens a replica (R = 2, adamw,
ADPSGD) under the config's remat: the card's peak held within 5 % of
the meta count with remat, which without remat passes 80 GiB; and at 2
layers one replica's gradients with remat off, "nothing" and "dots",
bitwise equal, their peaks in the order nothing < dots < off.  Work that
needs no card runs in helper processes that see none, started with the
script beside the card's phases: those two dry runs, phase 17's meta
count (``--remat-peaks``) and the CPU's draw of phase 2's uniforms (held
to the card's after phase 3c); phase 8, and phases 15 and 15b's CLI
runs, run as processes of their own on the card beside phase 9 (its
checkpoint I/O is host work) once the card's free memory holds all four,
and end before phase 15, so phase 9 alone is timed beside them.  The
process group is
destroyed before the last two lines.  Each path is driven with the launch counts set to 0 just
before it and read just after.

Phases: 1 environment and build (no kernel may spill registers; TF32
off, deterministic cuDNN); 2 kernels against their plain versions (the
grouped mean + sqdev in its five modes at every case and on a tree of
the cases at each R; the training phases hold it again on their final
W, and time one sync of it four ways); 3, 3b, 3c the training paths; 4
kernel timings; 5 serving; 6 the clock; 7 the last three strategies; 8
the CNN experiment; 9 checkpoint / resume; 10 the dense configs served;
11 the MoE family trained; 12 the MoE family served; 13a-c the
vision-language and audio models trained and served; 14a-c the Mamba
hybrid and xLSTM families trained and served; 15 the mesh backend
(after 9), 15b its ``replica_tp`` placement; 16 the dry run against the
card (after 15b); 17 OLMo-1B trained whole at 4096 tokens under remat.
Every training phase runs its config's activation rematerialisation
(``cfg.remat``, policy "nothing").  Each phase prints its seconds.  Any failed check exits non-zero.
The card's ``nvidia-smi`` name and power limit stand on the line before
the ``{"kernels": [...]}`` line, and the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before any phase.
"""
from __future__ import annotations

import atexit
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' bytes, operations and least times on an H100 SXM
from repro_torch.kernels.cost import (attention_pairs, flash_bound,  # noqa: E402
                                      fused_sync_bound, mean_sqdev_bound,
                                      qsgd_bound)

# the paths: OLMo-1B full width, 4 layers, R = 4, adamw
BASE_ARGV = ["--arch", "olmo-1b", "--backend", "vmap", "--no-reduced",
             "--layers", "4", "--replicas", "4", "--batch", "4",
             "--seq", "128", "--warmup-sync", "2", "--p-init", "2",
             "--lr", "4e-4", "--seed", "0"]
MAIN_ARGV = BASE_ARGV + ["--method", "adpsgd", "--steps", "16"]
QSGD_PERIODIC_ARGV = BASE_ARGV + ["--method", "qsgd_periodic",
                                  "--steps", "16"]
QSGD_ARGV = BASE_ARGV + ["--method", "qsgd", "--steps", "8"]
HIER_ARGV = BASE_ARGV + ["--method", "hier_adpsgd", "--inner-period", "2",
                         "--steps", "16"]
DASGD_ARGV = BASE_ARGV + ["--method", "dasgd", "--p-const", "4",
                          "--steps", "16"]
ADACOMM_ARGV = BASE_ARGV + ["--method", "adacomm", "--adacomm-mode", "time",
                            "--net", "10gbps", "--adacomm-t0", "2.0",
                            "--steps", "16"]
N_LEAVES = 29
N_PARAMS = 371_458_048        # per replica: OLMo-1B full width, 4 layers
# the paper's CNN experiment (benchmarks/common.py, BENCH_engine.json)
CNN_R, CNN_STEPS, CNN_LEAVES = 8, 60, 8
BITS = 8
DEVICE = "cuda"

# (R, shape): the reference's kernel-test shapes, then each distinct leaf
# shape of the paths
# shape of the OLMo path and each leaf of phase 8's CNN at its R
EMBED_SHAPE = (50304, 2048)
LEAF_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), EMBED_SHAPE]
CNN_LEAF_SHAPES = [(3, 3, 3, 16), (16,), (3, 3, 16, 32), (32,), (2048, 256),
                   (256,), (256, 10), (10,)]
# each distinct leaf shape of phase 11's DeepSeek (R = 4) that OLMo's have
# not: the experts, the router, MLA's projections and norm, the shared
# experts, layer 0's dense MLP, the norms, the embedding and the head
DEEPSEEK_LEAF_SHAPES = [(64, 2048, 1408), (64, 1408, 2048), (2048, 64),
                        (2048, 3072), (2048, 576), (512, 4096), (512,),
                        (2048, 2816), (2816, 2048), (2048, 10944),
                        (10944, 2048), (2048,), (102400, 2048),
                        (2048, 102400)]
# each distinct leaf shape of phase 13's Qwen2-VL-2B and Whisper-medium
# (R = 4) that the paths above have not: the embeddings, the attention
# projections (Qwen2-VL's two KV heads: 256 wide), the MLPs, the QKV and
# GELU biases, the norms
VLM_AUDIO_LEAF_SHAPES = [(151936, 1536), (1536, 1536), (1536, 256),
                         (1536, 8960), (8960, 1536), (256,), (1536,),
                         (51865, 1024), (1024, 1024), (1024, 4096),
                         (4096, 1024), (4096,), (1024,)]
# each distinct leaf shape of phase 14's xLSTM-350M (R = 4) that the paths
# above have not (the mLSTM's gate biases, norm, conv, projections and
# gates; the sLSTM's recurrence and feed-forward), then Jamba's Mamba
# block's (A_log, conv, dt_proj, x_proj, D; R = 2), each at R = 2 and 4
SSM_LEAF_SHAPES = [(4,), (2048,), (4, 2048), (2048, 2048), (4, 256, 1024),
                   (1024, 1344), (1344, 1024), (2048, 8), (2048, 1024),
                   (16384, 16), (4, 16384), (512, 16384), (16384, 544),
                   (16384,)]
KERNEL_CASES = ([(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3))]
                + [(4, s) for s in LEAF_SHAPES]
                + [(CNN_R, s) for s in CNN_LEAF_SHAPES]
                + [(4, s) for s in DEEPSEEK_LEAF_SHAPES]
                + [(4, s) for s in VLM_AUDIO_LEAF_SHAPES]
                + [(R, s) for R in (2, 4) for s in SSM_LEAF_SHAPES])
# (shape, bits): the reference's QSGD kernel-test cases, then the leaves
QSGD_CASES = ([((n,), b) for n in (7, 1000, 1024, 4097) for b in (4, 8)]
              + [((33, 17), 8)]
              + [(s, BITS) for s in LEAF_SHAPES + CNN_LEAF_SHAPES])
KERNEL_NAMES = ("mean_and_sqdev", "sqnorm", "quantize", "dequantize",
                "flash_attention")
# the counts a path is held to: each kernel's launches, and the leaves
# mean_and_sqdev's launches covered (a grouped launch covers a whole tree)
LEAVES = "mean_and_sqdev.leaves"
COUNTS = KERNEL_NAMES + (LEAVES,)
# flash attention (B, S, H, K, d), or (B, Sq, Sk, H, K, d): the reference's
# kernel-test shapes; the OLMo-1B prefill layer; GLM4-9B's GQA heads
# (configs/glm4_9b.py: H 32, K 2, d 128); one layer of the reference's
# prefill_32k shape (timed only)
FLASH_TEST_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 32),
                     (1, 384, 6, 3, 128), (2, 128, 8, 1, 64)]
OLMO_PREFILL = (4, 2048, 16, 16, 128)
GLM4_GQA = (1, 4096, 32, 2, 128)
PREFILL_32K = (1, 32768, 16, 16, 128)
# serving: OLMo-1B, all 16 layers, 4 x 2048 prefill; generate 4 x (128 + 128)
SERVE_BATCH, SERVE_SEQ, SERVE_PROMPT, SERVE_GEN = 4, 2048, 128, 128
# phase 10: the three dense configs at full width and depth, 1 x 2048
# prefill, generate 1 x (128 + 32); each one's prefill layer (B, S, H, K, d)
DENSE_ARCHS = {"minicpm-2b": (1, 2048, 36, 36, 64),
               "glm4-9b": (1, 2048, 32, 2, 128),
               "qwen2.5-14b": (1, 2048, 40, 8, 128)}
DENSE_BATCH, DENSE_SEQ, DENSE_PROMPT, DENSE_GEN = 1, 2048, 128, 32
# phase 9: phase 3 split 8 + 8; phase 7's dasgd split between a snapshot
# and its apply
RESUME_AT = 8
# phase 11: DeepSeek-V2-Lite at full width, 2 layers (the dense layer 0 and
# one MoE layer), R = 4, adamw, MAIN_ARGV's other flags
DEEPSEEK_ARGV = ["--arch", "deepseek-v2-lite-16b", "--backend", "vmap",
                 "--no-reduced", "--layers", "2", "--replicas", "4",
                 "--batch", "4", "--seq", "128", "--warmup-sync", "2",
                 "--p-init", "2", "--lr", "4e-4", "--seed", "0",
                 "--method", "adpsgd", "--steps", "16"]
DEEPSEEK_LEAVES = 27
DEEPSEEK_PARAMS = 1_085_287_424     # per replica, 2 layers
# phase 12: DeepSeek-V2-Lite at full width and depth, Mixtral-8x22B at full
# width cut to 4 of 56 layers; 1 x 2048 prefill, generate 1 x (128 + 32)
MOE_SERVE = {"deepseek-v2-lite-16b": (0, 15_706_484_224, 2_661_150_208),
             "mixtral-8x22b": (4, 10_418_903_040, 3_171_145_728)}
# phase 13: Qwen2-VL-2B and Whisper-medium at full width and depth, R = 4,
# each config's optimizer (momentum / adamw), DEEPSEEK_ARGV's other flags;
# Whisper at batch 2 x 512 tokens with 1500 seeded frames a sample
QWEN_VL_ARGV = ["--arch", "qwen2-vl-2b", "--backend", "vmap",
                "--no-reduced", "--replicas", "4", "--batch", "4",
                "--seq", "128", "--warmup-sync", "2", "--p-init", "2",
                "--lr", "4e-4", "--seed", "0", "--method", "adpsgd",
                "--steps", "16"]
WHISPER_ARGV = ["--arch", "whisper-medium", "--backend", "vmap",
                "--no-reduced", "--replicas", "4", "--batch", "2",
                "--seq", "512", "--warmup-sync", "2", "--p-init", "2",
                "--lr", "4e-4", "--seed", "0", "--method", "adpsgd",
                "--steps", "16"]
# (leaves, params) per replica, the reference's jax.eval_shape
VLM_AUDIO_TRAIN = {"qwen2-vl-2b": (338, 1_543_714_304),
                   "whisper-medium": (725, 758_248_448)}
# serving, each one's prefill layer (B, S, H, K, d): Qwen2-VL 1 x (64
# patches + 1984 tokens), generate 1 x (128 + 32) text only; Whisper's
# decoder 4 x 512 over 1500 frames, generate 4 x (128 + 32)
VLM_AUDIO_ARCHS = {"qwen2-vl-2b": (1, 2048, 12, 2, 128),
                   "whisper-medium": (4, 512, 16, 16, 64)}
VLM_AUDIO_PROMPT, VLM_AUDIO_GEN = 128, 32
# phase 14a: xLSTM-350M at full width and depth (21 mLSTM + 3 sLSTM), R =
# 4, adamw, DEEPSEEK_ARGV's other flags; 14b: Jamba-1.5-Large at full
# width cut to layer 0 (Mamba + dense SwiGLU MLP), R = 2 (each MoE layer
# alone is 9.66 B parameters, 38.7 GB in f32: none trains at R >= 2 on one
# card; layer 0 at R = 4 with adamw needs about 109 GB)
XLSTM_ARGV = ["--arch", "xlstm-350m", "--backend", "vmap", "--no-reduced",
              "--replicas", "4", "--batch", "4", "--seq", "128",
              "--warmup-sync", "2", "--p-init", "2", "--lr", "4e-4",
              "--seed", "0", "--method", "adpsgd", "--steps", "16"]
JAMBA_ARGV = ["--arch", "jamba-1.5-large-398b", "--backend", "vmap",
              "--no-reduced", "--layers", "1", "--replicas", "2",
              "--batch", "4", "--seq", "128", "--warmup-sync", "2",
              "--p-init", "2", "--lr", "4e-4", "--seed", "0",
              "--method", "adpsgd", "--steps", "16"]
# (leaves, params) per replica, the reference's jax.eval_shape
SSM_TRAIN = {"xlstm-350m": (303, 476_656_808),
             "jamba-1.5-large-398b": (17, 2_098_077_696)}
# phase 14c: xLSTM-350M whole (f32 parameters); Jamba-1.5-Large at full
# width cut to layers 0-4 of 72 (four Mamba, attention at index 4, MoE on
# layers 1 and 3) with bf16 parameters (48.09 GB; the same five layers are
# 96.2 GB in f32, and the largest f32 prefix that fits, 3 layers, has no
# attention layer); each (layers, param dtype, params); 1 x 2048 prefill,
# generate 1 x (128 + 32)
SSM_SERVE = {"xlstm-350m": (0, "float32", 476_656_808),
             "jamba-1.5-large-398b": (5, "bfloat16", 24_045_707_264)}
# Jamba's prefill attention layer (B, S, H, K, d): GQA 64 / 8, no
# positions, no window
JAMBA_PREFILL = (1, 2048, 64, 8, 128)
# phase 17: OLMo-1B at full width and all 16 layers at train_4k's 4096
# tokens, R = 2, adamw, ADPSGD, under the config's remat ("nothing"); the
# per-replica batch is the least at which remat off's meta peak passes 80
# GiB while remat "nothing" leaves 10 GiB of them free (meta, this
# script's --remat-peaks: 85.45 and 39.08 GiB at 2; 56.97 and 34.87 at 1)
REMAT_R, REMAT_BATCH, REMAT_SEQ = 2, 2, 4096
REMAT_ARGV = ["--arch", "olmo-1b", "--backend", "vmap", "--no-reduced",
              "--layers", "16", "--replicas", str(REMAT_R),
              "--batch", str(REMAT_BATCH), "--seq", str(REMAT_SEQ),
              "--warmup-sync", "2", "--p-init", "2", "--lr", "4e-4",
              "--seed", "0", "--method", "adpsgd", "--steps", "6"]
REMAT_TRAIN = (113, 1_176_764_416)     # leaves, params per replica
REMAT_CARD_GIB, REMAT_FREE_GIB = 80, 10
REMAT_PEAK_TOL = 0.05                  # the card's peak against the meta one
REMAT_POLICIES = ("off", "nothing", "dots")
REMAT_B_LAYERS = 2                     # (b): off / nothing / dots at 2 layers


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels import qsgd_quant as qq
    return {"mean_and_sqdev": pv.mean_and_sqdev, "sqnorm": qq.sqnorm,
            "quantize": qq.quantize, "dequantize": qq.dequantize,
            "flash_attention": fa.flash_attention}


def reset_counts() -> None:
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    fns["mean_and_sqdev"].leaves = 0


def read_counts() -> dict:
    fns = kernel_fns()
    return dict({name: fn.launches for name, fn in fns.items()},
                **{LEAVES: fns["mean_and_sqdev"].leaves})


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


# ------------------------------------------------------------------ phase 2
def phase_kernels(device) -> dict:
    """The CUDA mean_and_sqdev against its plain version on the card, and
    run twice for a bitwise repeat.  Tolerances: mean atol 1e-6 (one f32
    rounding of the same four-term sum); sq rtol 1e-5, or 1e-4 on a leaf
    of more than 1e8 elements (the embeddings, DeepSeek's head and
    experts), where the order of summation over 4e8 terms and more
    differs."""
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
        tol = 1e-4 if math.prod(shape) > 1e8 else 1e-5
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


def check_grouped(leaves, source, label: str) -> dict:
    """The grouped mean_and_sqdev in its three modes over ``leaves`` (one
    tree, on the card) against the plain version: the means (the output
    of mode mean, every row after the sync) and the deltas bitwise; W
    bitwise unchanged by mean and delta; each leaf's sq within rtol 1e-5,
    or 1e-4 on a leaf of more than 1e8 elements a replica (f32 sums over
    4e8 terms and more in another order); S_k within rtol 1e-5; each mode
    run twice and bitwise the same; one launch covering every leaf per
    call.  ``source(i)`` gives leaf i as it was: the sync writes W, which
    is put back from it before the repeat.  Returns the largest
    errors."""
    import torch
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels.ref import mean_and_sqdev_ref

    R, L = leaves[0].shape[0], len(leaves)
    means, sqs = zip(*(mean_and_sqdev_ref(x) for x in leaves))
    want_sq, want_s_k = torch.stack(sqs), sum(sqs) / R
    tol = torch.tensor([1e-4 if x[0].numel() > 1e8 else 1e-5
                        for x in leaves], device=want_sq.device)
    sq_rel = s_k_rel = 0.0
    for mode in ("mean", "delta", "sync"):
        runs = []
        for rep in range(2):
            if mode == "sync" and rep:
                for i, x in enumerate(leaves):
                    x.copy_(source(i))
            out = None if mode == "sync" else pv.new_out(leaves, mode)
            before = (pv.mean_and_sqdev.launches, pv.mean_and_sqdev.leaves)
            sq, s_k = pv.mean_and_sqdev_many(leaves, mode, out)
            launched = (pv.mean_and_sqdev.launches - before[0],
                        pv.mean_and_sqdev.leaves - before[1])
            views = None if out is None else pv.out_views(out, leaves, mode)
            for i, (x, m) in enumerate(zip(leaves, means)):
                if mode == "sync":
                    ok = torch.equal(x, m.unsqueeze(0).expand_as(x))
                elif mode == "mean":
                    ok = torch.equal(views[i], m)
                else:
                    ok = torch.equal(views[i], m.unsqueeze(0) - x)
                check(ok, f"{label}: mode {mode} differs from plain at leaf "
                          f"{i} {tuple(x.shape)}")
            del out, views
            runs.append((sq, s_k))
            check(launched == (1, L), f"{label}: mode {mode} made "
                                      f"{launched} (launches, leaves)")
        (sq, s_k), (sq2, s_k2) = runs
        check(torch.equal(sq, sq2) and torch.equal(s_k, s_k2),
              f"{label}: mode {mode} not bitwise repeatable")
        check(bool(((sq - want_sq).abs() <= tol * want_sq).all()),
              f"{label}: mode {mode} sq beyond its tolerance")
        rel = abs(float(s_k) - float(want_s_k)) / max(float(want_s_k), 1e-30)
        check(rel <= 1e-5, f"{label}: mode {mode} S_k rel {rel} > 1e-5")
        pos = want_sq > 0
        if bool(pos.any()):
            sq_rel = max(sq_rel, float(((sq - want_sq).abs()[pos]
                                        / want_sq[pos]).max()))
        s_k_rel = max(s_k_rel, rel)
        if mode == "delta":        # the four reads left W as it was
            check(all(torch.equal(x, source(i))
                      for i, x in enumerate(leaves)),
                  f"{label}: mode mean or delta wrote W")
    print(f"  grouped {label}: {L} leaves R={R} s_k={float(want_s_k)!r} "
          f"max sq rel {sq_rel:.3e} s_k rel {s_k_rel:.3e}; means, deltas "
          f"bitwise; repeats bitwise; 1 launch a call")
    return {"sq_rel": sq_rel, "s_k_rel": s_k_rel}


def check_grouped_given(leaves, source, label: str) -> dict:
    """The grouped mean_and_sqdev in modes sync_to and delta_to (the mesh
    backend's write-back of the all-reduced sum of the ranks' means, and
    its DaSGD delta over the snapshot in place), given each leaf's plain
    sum over its rows in index order and the divisor R: the sum over R,
    a true division, is the plain mean bit for bit (checked), so every
    row must equal the plain mean, and mean − w, bitwise; each leaf's sq
    within ``check_grouped``'s tolerance; S_k within rtol 1e-5; each mode
    twice, bitwise the same; one launch covering every leaf per call.
    ``source(i)`` gives leaf i as it was (both modes write).  One delta
    buffer serves both runs of delta_to, so a tree of 20 GB fits beside
    its copy."""
    import torch
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels.ref import mean_and_sqdev_ref

    release()
    R, L = leaves[0].shape[0], len(leaves)
    given = pv.new_out(leaves, "mean")
    sums = pv.out_views(given, leaves, "mean")
    divisor = torch.tensor(float(R), device=given.device)
    sqs = []
    for i, (x, s) in enumerate(zip(leaves, sums)):
        x.copy_(source(i))                  # a sync may have written it
        m_ref, sq = mean_and_sqdev_ref(x)
        s.copy_(x[0])
        for r in range(1, R):
            s.add_(x[r])
        check(torch.equal(s / divisor, m_ref),
              f"{label}: the plain sum over R is not the plain mean at "
              f"leaf {i}")
        sqs.append(sq)
        del m_ref
    want_sq, want_s_k = torch.stack(sqs), sum(sqs) / R
    tol = torch.tensor([1e-4 if x[0].numel() > 1e8 else 1e-5
                        for x in leaves], device=want_sq.device)
    sq_rel = s_k_rel = 0.0
    for mode in ("sync_to", "delta_to"):
        out = None if mode == "sync_to" else pv.new_out(leaves, mode)
        targets = leaves if out is None else pv.out_views(out, leaves, mode)
        runs = []
        for rep in range(2):
            for i, t in enumerate(targets):
                t.copy_(source(i))
            before = (pv.mean_and_sqdev.launches, pv.mean_and_sqdev.leaves)
            sq, s_k = pv.mean_and_sqdev_many(targets, mode, out, given, R)
            launched = (pv.mean_and_sqdev.launches - before[0],
                        pv.mean_and_sqdev.leaves - before[1])
            check(launched == (1, L), f"{label}: mode {mode} made "
                                      f"{launched} (launches, leaves)")
            for i, (t, s) in enumerate(zip(targets, sums)):
                m = s / divisor
                ok = (torch.equal(t, m.unsqueeze(0).expand_as(t))
                      if mode == "sync_to"
                      else torch.equal(t, m.unsqueeze(0) - source(i)))
                check(ok, f"{label}: mode {mode} differs from plain at leaf "
                          f"{i}")
                del m
            runs.append((sq, s_k))
        del out, targets
        (sq, s_k), (sq2, s_k2) = runs
        check(torch.equal(sq, sq2) and torch.equal(s_k, s_k2),
              f"{label}: mode {mode} not bitwise repeatable")
        check(bool(((sq - want_sq).abs() <= tol * want_sq).all()),
              f"{label}: mode {mode} sq beyond its tolerance")
        rel = abs(float(s_k) - float(want_s_k)) / max(float(want_s_k), 1e-30)
        check(rel <= 1e-5, f"{label}: mode {mode} S_k rel {rel} > 1e-5")
        pos = want_sq > 0
        if bool(pos.any()):
            sq_rel = max(sq_rel, float(((sq - want_sq).abs()[pos]
                                        / want_sq[pos]).max()))
        s_k_rel = max(s_k_rel, rel)
    for i, x in enumerate(leaves):
        x.copy_(source(i))
    del given, sums
    print(f"  grouped given sum / R {label}: {L} leaves R={R} max sq rel "
          f"{sq_rel:.3e} s_k rel {s_k_rel:.3e}; writes bitwise; repeats "
          f"bitwise; 1 launch a call")
    return {"sq_rel": sq_rel, "s_k_rel": s_k_rel}


def phase_grouped_kernels(device) -> dict:
    """The grouped mean_and_sqdev (``check_grouped``, then
    ``check_grouped_given``) at every ``KERNEL_CASES`` shape alone, then
    on one tree of all the cases' shapes at each R that has several; W
    drawn on the card from a seed per leaf, and drawn again to put it back
    or to hold it unchanged."""
    import torch

    gen = torch.Generator(device=device)

    def draw(R, shape, seed):
        gen.manual_seed(seed)
        return torch.randn((R, *shape), generator=gen, device=device)

    worst = {"sq_rel": 0.0, "s_k_rel": 0.0}
    cases = [(R, shape, 100 + i) for i, (R, shape) in enumerate(KERNEL_CASES)]
    trees = [[case] for case in cases]
    for R in sorted({r for r, _ in KERNEL_CASES}):
        tree = [case for case in cases if case[0] == R]
        if len(tree) > 1:
            trees.append(tree)
    for tree in trees:
        R = tree[0][0]
        leaves = [draw(*leaf) for leaf in tree]
        label = (f"R={R} {tree[0][1]}" if len(tree) == 1
                 else f"tree of the R={R} cases")
        errs = check_grouped(leaves, lambda i, t=tree: draw(*t[i]), label)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        errs = check_grouped_given(leaves, lambda i, t=tree: draw(*t[i]),
                                   label)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        del leaves
    release()
    return worst


def check_grouped_on_W(W, label: str, seed: int) -> dict:
    """``check_grouped`` on a training phase's final W, after its optimizer
    state is freed: 0.01·N(0, 1) from ``seed`` is added to every replica
    first (a run may end on a sync, which leaves the replicas equal), and
    W is kept on the host to put it back and to hold it unchanged."""
    import torch
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(W)
    gen = torch.Generator(device=leaves[0].device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for x in leaves:
            x.add_(torch.randn(x.shape, generator=gen, device=x.device),
                   alpha=0.01)
    host = [x.to("cpu", copy=True) for x in leaves]

    def source(i):
        return host[i].to(leaves[i].device)
    t0 = time.perf_counter()
    errs = check_grouped(leaves, source, label)
    print(f"  grouped {label}: {time.perf_counter() - t0:.1f} s")
    del host
    return errs


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
    errs["sqnorm"] = max(errs["sqnorm"], phase_sqnorm_many(device))
    t0 = time.perf_counter()
    on_card = prng.uniform(uniform_key(), EMBED_SHAPE, device=device).cpu()
    card_s = time.perf_counter() - t0
    errs["uniform"] = {"sha256": digest(on_card), "card_s": card_s}
    print(f"  uniform {EMBED_SHAPE} drawn on the card in {card_s:.3f} s with "
          f"copy; held to the CPU's draw (a helper process) after phase 3c")
    del on_card
    release()
    return errs


def uniform_key():
    """The key of phase 2's uniform draw at the embedding's shape."""
    from repro_torch.core import prng
    return prng.split(prng.fold_in(prng.prng_key(17), 3), N_LEAVES)[0]


def digest(t) -> str:
    """sha256 of a CPU tensor's dtype, shape and bytes."""
    import hashlib
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.contiguous().numpy().view("uint8"))
    return h.hexdigest()


def main_cpu_uniform() -> int:
    """``--cpu-uniform``: phase 2's uniform drawn on the CPU; prints its
    digest and seconds as JSON (``start_cpu_job`` runs it beside the
    card's phases)."""
    from repro_torch.core import prng
    t0 = time.perf_counter()
    on_cpu = prng.uniform(uniform_key(), EMBED_SHAPE, device="cpu")
    print(json.dumps({"sha256": digest(on_cpu),
                      "cpu_s": time.perf_counter() - t0}))
    return 0


def check_uniform(card: dict, job: dict) -> None:
    """Phase 2's uniform: the card's draw equal, bit for bit, to the
    CPU's (the helper process's digest)."""
    rc, out, err, wall = finish_cpu_job(job)
    check(rc == 0, "the CPU uniform draw failed:\n" + out[-2000:]
          + err[-2000:])
    cpu = json.loads(out.strip().splitlines()[-1])
    same = cpu["sha256"] == card["sha256"]
    print(f"  phase 2's uniform {EMBED_SHAPE} card == cpu: {same} (card "
          f"{card['card_s']:.3f} s with copy, cpu {cpu['cpu_s']:.3f} s in a "
          f"helper process, collected {wall:.1f} s after its start)")
    check(same, "uniforms on the card differ from the CPU's")


# ------------------------------------------------------------ helper jobs
_JOBS = []          # the helper processes this script started


def start_cpu_job(argv, threads: int = 1) -> dict:
    """Start ``python argv...`` as a process that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty) and uses ``threads`` CPU threads, so
    that its host work runs beside the card's phases; ``finish_cpu_job``
    collects it, and ``stop_cpu_jobs`` kills any still running."""
    import os
    return start_job(argv, dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                CUDA_VISIBLE_DEVICES="",
                                OMP_NUM_THREADS=str(threads)))


def start_job(argv, env) -> dict:
    """Start ``python argv...`` in ``env`` from the checkout's root, its
    output kept in temporary files (``finish_cpu_job`` reads them)."""
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=out, stderr=err, text=True)
    job = {"proc": proc, "out": out, "err": err, "t0": time.perf_counter()}
    _JOBS.append(job)
    return job


def wait_job(job: dict, timeout: float = 600.0) -> int:
    """Wait for a job to end (killed, exit code -9, if it outlives
    ``timeout``), keeping when it ended; its exit code."""
    if "ended" not in job:
        try:
            job["proc"].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            job["proc"].kill()
            job["proc"].wait()
        job["ended"] = time.perf_counter()
    return job["proc"].returncode


def finish_cpu_job(job: dict, timeout: float = 600.0) -> tuple:
    """Wait for a helper job: (exit code, stdout, stderr, seconds from its
    start to its end).  One that outlives ``timeout`` is killed (exit
    code -9)."""
    rc = wait_job(job, timeout)
    texts = []
    for f in (job["out"], job["err"]):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return rc, texts[0], texts[1], job["ended"] - job["t0"]


def stop_cpu_jobs() -> None:
    """Kill every helper job still running (a failed check ends the
    script before it collects them)."""
    for job in _JOBS:
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()


def phase_sqnorm_many(device) -> float:
    """sqnorm_many against its plain version on the card: one tensor of 1,
    7, 4097 and 103,022,592 (the embedding) elements, and the 29 leaves of
    one replica of the training paths' model in one group.  Each sum within
    rtol 1e-5 (1e-4 on the embedding, as sqnorm's), bitwise repeatable,
    bit-identical to sqnorm of the tensor alone; one launch per call.
    Returns the largest absolute error."""
    import torch
    from repro_torch.kernels import qsgd_quant as qq
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    leaves = ([EMBED_SHAPE] + [LEAF_SHAPES[0]] * 16 + [LEAF_SHAPES[1]] * 8
              + [LEAF_SHAPES[2]] * 4)
    groups = [[(1,)], [(7,)], [(4097,)], [EMBED_SHAPE], leaves]
    max_abs = 0.0
    for shapes in groups:
        xs = [torch.randn(s, generator=gen, device=device) * 3.0
              for s in shapes]
        before = qq.sqnorm.launches
        sq, sq2 = qq.sqnorm_many(xs), qq.sqnorm_many(xs)
        launches = qq.sqnorm.launches - before
        alone = torch.stack([qq.sqnorm(x) for x in xs])
        want = ref.sqnorm_many_ref(xs)
        torch.cuda.synchronize()
        tol = torch.tensor([1e-4 if tuple(s) == EMBED_SHAPE else 1e-5
                            for s in shapes], device=device)
        rel = (sq - want).abs() / want
        print(f"  sqnorm_many {len(xs)} tensors "
              f"({sum(x.numel() for x in xs)} elements): max rel "
              f"{float(rel.max()):.3e} repeat={torch.equal(sq, sq2)} "
              f"equal_to_alone={torch.equal(sq, alone)} launches={launches}")
        check(bool((rel <= tol).all()), f"sqnorm_many rel error "
              f"{float(rel.max())} over {len(xs)} tensors")
        check(torch.equal(sq, sq2), "sqnorm_many not repeatable")
        check(torch.equal(sq, alone),
              "sqnorm_many differs from sqnorm of the tensor alone")
        check(launches == 2, f"two sqnorm_many calls made {launches} launches")
        max_abs = max(max_abs, float((sq - want).abs().max()))
        del xs, sq, sq2, alone, want
    release()
    return max_abs


def qkv(shape, dtype, gen, device):
    import torch
    B, Sq, Sk, H, K, d = shape if len(shape) == 6 else (shape[:2] + shape[1:])
    return tuple(torch.randn((B, S, n, d), generator=gen, device=device)
                 .to(dtype) for S, n in ((Sq, H), (Sk, K), (Sk, K)))


def flash_cases_per_instance():
    """Cases for every bf16 instance (the SIMT one at d = 32, the wgmma
    one at 64 and 128): one 128 x 128 tile, non-causal and causal; then
    several 128-row tiles (S = 640), S = 100, Sq != Sk (and a ragged Sk),
    GLM4's 16:1 GQA, each causal, with windows 64 and 200, and
    non-causal."""
    import torch
    bf16 = torch.bfloat16
    cases = []
    for d in (128, 64, 32):
        cases += [((1, 128, 128, 1, 1, d), bf16, c, 0, {})
                  for c in (False, True)]
        cases += [(shape, bf16, c, w, {})
                  for shape in ((1, 640, 640, 4, 2, d), (1, 100, 100, 4, 2, d),
                                (1, 128, 384, 4, 2, d), (1, 256, 100, 4, 2, d),
                                (1, 256, 256, 32, 2, d))
                  for c, w in ((True, 0), (True, 64), (True, 200),
                               (False, 0))]
    return cases


# The wgmma instance's P enters p·v as two bf16 parts, hi + lo, within
# 2^-16 of P (|P - hi| <= 2^-8 |P|, and lo rounds P - hi to 8 bits): its f32
# output lies within 2^-16 · Σ_j w_j |v_j| of exact p·v.  Allowing as much
# again for the f32 arithmetic of both sides (scores, exponentials, sums in
# another order), two bf16 roundings leave |kernel - plain| within one bf16
# ulp of the larger of the two plus 2^-15 · Σ_j w_j |v_j| (attention_ref of
# |v|).  Near zero an ulp is finer than any f32 sum can resolve, so "one ulp
# everywhere" alone cannot hold: on the CPU the plain version itself lies up
# to 8 ulps from a float64 evaluation at (1, 1024, 4, 4, 128).
P_SPLIT_REL = 2.0 ** -15


def bf16_ulp_stats(out, want, scale) -> dict:
    """bf16 ``out`` against bf16 ``want``: the count of elements that
    differ at all, the largest distance in ulps of the larger magnitude,
    and the largest excess of |out - want| over one ulp plus
    ``P_SPLIT_REL · scale`` (must be <= 0)."""
    import torch

    big = torch.maximum(out.float().abs(), want.float().abs())
    big = torch.where(big > 0, big, torch.ones_like(big))   # d is 0 there
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    d = (out.float() - want.float()).abs()
    return {"differ": int((d > 0).sum()), "n": d.numel(),
            "max_ulps": float((d / ulp).max()),
            "excess": float((d - ulp - P_SPLIT_REL * scale).max())}


def phase_flash_kernels(device, ulp_check: bool = True) -> dict:
    """flash attention against its plain version (attention_ref) on the
    card: first the cases of every bf16 instance (a single 128 x 128 tile
    before anything larger), then the reference's kernel-test cases (4
    shapes x f32/bf16 x window 0/64, causal, and the block-size case) at
    its tolerances, atol = rtol = 2e-5 in f32 and 2e-2 in bf16 (online
    against exact softmax; one bf16 rounding of the output); the prefill
    layers of phase 10's three dense configs, of phase 13's Qwen2-VL and
    Whisper decoder and of phase 14's Jamba, the OLMo-1B prefill layer,
    GLM4-9B's GQA heads and causal=False in bf16.  Every call is run twice
    for a bitwise repeat, adds 1 to the launch count each time, and a
    length the reference refuses raises.  On the wgmma instance (bf16, d
    64 and 128) each case also prints the share of output elements that
    differ from the plain version, their distance in bf16 ulps and the
    excess over the bound of ``P_SPLIT_REL``; with ``ulp_check`` no element
    may exceed it.  Returns the largest error and the wgmma cases'
    totals."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    f32, bf16 = torch.float32, torch.bfloat16
    cases = flash_cases_per_instance()
    cases += [(s, dt, True, w, {}) for s in FLASH_TEST_SHAPES
              for dt in (f32, bf16) for w in (0, 64)]
    cases += [((1, 256, 4, 2, 64), f32, True, 0,
               {"block_q": bq, "block_k": bk})
              for bq, bk in ((64, 64), (128, 64), (64, 128))]
    cases += [(shape, bf16, True, 0, {}) for shape in
              list(DENSE_ARCHS.values()) + list(VLM_AUDIO_ARCHS.values())
              + [JAMBA_PREFILL]]
    cases += [(OLMO_PREFILL, bf16, True, 0, {}), (GLM4_GQA, bf16, True, 0, {}),
              ((2, 256, 4, 2, 32), f32, False, 0, {}),
              ((2, 256, 4, 2, 32), bf16, False, 0, {}),
              (OLMO_PREFILL, bf16, False, 0, {})]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    max_err = 0.0
    wgmma = {"differ": 0, "n": 0, "max_ulps": 0.0, "excess": -math.inf}
    for shape, dtype, causal, window, blocks in cases:
        q, k, v = qkv(shape, dtype, gen, device)
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 **blocks)
        again = fa.flash_attention(q, k, v, causal=causal, window=window,
                                   **blocks)
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == f32 else 2e-2
        err = float((out.float() - want.float()).abs().max())
        excess = float(((out.float() - want.float()).abs()
                        - tol * want.float().abs()).max())
        repeat = torch.equal(out, again)
        ulps = ""
        on_wgmma = dtype == bf16 and shape[-1] in (64, 128)
        if on_wgmma:
            scale = attention_ref(q.float(), k.float(), v.float().abs(),
                                  causal=causal, window=window)
            st = bf16_ulp_stats(out, want, scale)
            del scale
            ulps = (f" differ={st['differ']}/{st['n']} "
                    f"({st['differ'] / st['n']:.3e}) "
                    f"max_ulps={st['max_ulps']:.3f} "
                    f"excess={st['excess']:.3e}")
            for key in ("differ", "n"):
                wgmma[key] += st[key]
            for key in ("max_ulps", "excess"):
                wgmma[key] = max(wgmma[key], st[key])
        print(f"  flash {shape} {str(dtype)[6:]} causal={causal} "
              f"window={window} {blocks or ''}: max_abs_err={err:.3e} "
              f"(atol=rtol={tol}) bitwise_repeat={repeat}{ulps}")
        check(out.shape == q.shape and out.dtype == dtype,
              f"flash output {tuple(out.shape)} {out.dtype} at {shape}")
        check(excess <= tol, f"flash differs from plain by {err} at {shape}")
        check(repeat, f"flash not bitwise repeatable at {shape}")
        check(fa.flash_attention.launches == before + 2,
              f"flash launch count moved by "
              f"{fa.flash_attention.launches - before}, not 2")
        if on_wgmma and ulp_check:
            check(st["excess"] <= 0.0,
                  f"flash (wgmma) exceeds one bf16 ulp + {P_SPLIT_REL} x "
                  f"sum w|v| by {st['excess']} at {shape}")
        max_err = max(max_err, err)
        del q, k, v, out, again, want
    wgmma["share"] = wgmma["differ"] / wgmma["n"]
    print(f"  flash wgmma instance, all bf16 d 64/128 cases: {wgmma['differ']}"
          f" of {wgmma['n']} elements differ from plain (share "
          f"{wgmma['share']!r}); max {wgmma['max_ulps']!r} ulps; largest "
          f"excess over one ulp + "
          f"{P_SPLIT_REL} x sum w|v|: {wgmma['excess']!r}")
    for shape, err in (((1, 200, 2, 2, 64), "multiples"),
                       ((1, 128, 2, 2, 48), "head dims")):
        q, k, v = qkv(shape, bf16, gen, device)
        try:
            fa.flash_attention(q, k, v)
            refused = False
        except ValueError as e:
            refused = err in str(e)
        print(f"  flash {shape} refused with ValueError ({err}): {refused}")
        check(refused, f"flash accepted {shape}")
    release()
    return {"max_abs_err": max_err, "wgmma": wgmma}


# ------------------------------------------------------------- phases 3-3c
def drive(argv, callbacks=(), wrap=None, time_programs=True,
          setup=None, n_leaves_want=N_LEAVES) -> dict:
    """Build the engine through the training CLI's own setup, time each of
    its programs (host clock between synchronisations, unless
    ``time_programs`` is False), set the launch counts to 0, run, and read
    the counts.  ``wrap(engine, name, program)`` may wrap a program
    further (inside the timer); ``setup(engine)`` runs before the run."""
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
          f"backend={engine.backend.describe()}; "
          f"{torch.cuda.memory_reserved()} B reserved after the setup")
    times, calls = {}, {}

    def timed(name, fn):
        def run(*a):
            calls[name] = calls.get(name, 0) + 1
            if not time_programs:
                return fn(*a)
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

    if setup is not None:
        setup(engine)
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
    check(n_leaves == n_leaves_want,
          f"{n_leaves} leaves, expected {n_leaves_want}")
    check(len(hist.losses) == args.steps, "not every step reported a loss")
    check(all(math.isfinite(x) for x in hist.losses), "non-finite loss")
    check(all(math.isfinite(x) for x in hist.s_k), "non-finite S_k")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(engine.W)),
          "non-finite final parameters")
    return {"engine": engine, "hist": hist, "launches": launches,
            "ms": medians, "calls": calls, "peak_bytes": peak,
            "n_syncs": hist.n_syncs, "n_params": n_params}


def plain_sync_probe():
    """A callback that keeps the plain S_k of the W each sync is about to
    average (steps the controller has just scheduled a sync at)."""
    import torch
    from repro_torch.kernels.ref import mean_and_sqdev_ref
    from repro_torch.runtime.engine import Callback
    from repro_torch.tree import tree_leaves

    class PlainProbe(Callback):
        def __init__(self):
            self.plain = {}

        def on_step_end(self, engine, k, metrics):
            if engine.strategy.controller.sync_steps[-1:] == [k]:
                with torch.no_grad():
                    leaves = tree_leaves(engine.W)
                    self.plain[k] = float(
                        sum(mean_and_sqdev_ref(x)[1] for x in leaves)
                        / leaves[0].shape[0])
    return PlainProbe()


def check_against_plain(hist, probe, launches, n_leaves) -> list:
    """At least 4 syncs, one mean_and_sqdev launch per sync covering its
    ``n_leaves`` leaves and no other kernel, each sync's S_k beside the
    plain one and the last within rtol 1e-4.  Returns the relative
    errors."""
    print(f"  s_k_plain={[probe.plain.get(k) for k in hist.sync_steps]}")
    check(hist.n_syncs >= 4, f"only {hist.n_syncs} syncs")
    check_sync_launches(launches, hist.n_syncs, n_leaves)
    rels = [abs(s - probe.plain[k]) / abs(probe.plain[k])
            for k, s in zip(hist.sync_steps, hist.s_k)]
    print(f"  s_k rel err kernel vs plain per sync={rels}")
    check(rels[-1] <= 1e-4, f"last sync S_k rel err {rels[-1]} > 1e-4")
    return rels


def phase_main_path() -> dict:
    """ADPSGD; each sync's S_k against the plain version on the same
    pre-sync W; then the grouped kernel on the final W
    (``check_grouped_on_W``)."""
    probe = plain_sync_probe()
    out = drive(MAIN_ARGV, callbacks=[probe])
    hist = out.pop("hist")
    check_against_plain(hist, probe, out["launches"], N_LEAVES)
    engine = out.pop("engine")
    out["trajectory"] = (hist.sync_steps, hist.losses, hist.s_k)
    out["resume_ref"] = resume_ref(engine, hist)
    out["grouped"] = grouped_on_final_W(engine, hist, "OLMo-1B W", 31)
    return out


def grouped_on_final_W(engine, hist, label: str, seed: int) -> dict:
    """Free a finished run's optimizer state, then ``check_grouped_on_W``
    on its W (which the check leaves noised: the run is over)."""
    engine.opt_state = hist.final_opt = None
    release()
    return check_grouped_on_W(engine.W, label, seed)


def resume_ref(engine, hist) -> dict:
    """A run's history and its final W on the host: what phase 9's resumed
    run must reproduce bit for bit."""
    from repro_torch.tree import tree_leaves
    return {"losses": hist.losses, "sync_steps": hist.sync_steps,
            "period_history": hist.period_history, "s_k": hist.s_k,
            "n_syncs": hist.n_syncs,
            "W": [x.cpu() for x in tree_leaves(engine.W)]}


def phase_qsgd_periodic() -> dict:
    """qsgd_periodic: the seeding sync costs one mean_and_sqdev launch
    over the 29 leaves, each later sync 29 of sqnorm (one per leaf, over
    its 4 deltas), 29 x 4 of quantize and dequantize, and 29 of
    mean_and_sqdev (one leaf each).  At the last
    sync the kernel route's S_k is held against the plain route's on the
    same W, anchor and key (rtol 1e-4: the norms differ by rounding, which
    can flip a level where u is within an ulp of its fraction)."""
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
    want = {"mean_and_sqdev": 1 + N_LEAVES * (n - 1),
            LEAVES: N_LEAVES * n, "sqnorm": N_LEAVES * (n - 1),
            "quantize": q, "dequantize": q, "flash_attention": 0}
    check(n >= 4, f"only {n} syncs")
    check(out["launches"] == want, f"launches {out['launches']} != {want}")
    s_k_kernel = hist.s_k[-1]
    out["mesh_ref"] = dict(resume_ref(engine, hist), ms=out["ms"])
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
    (max |W_r - W_0| = 0 on every leaf); launches = 8 x 4 x 29 of quantize
    and dequantize, and 8 x 4 of sqnorm (one per replica, over its 29
    leaves)."""
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
    want = {"mean_and_sqdev": 0, LEAVES: 0, "sqnorm": steps * 4,
            "quantize": q, "dequantize": q, "flash_attention": 0}
    print(f"  max |W_r - W_0| after each step: {probe.max_diff}")
    check(steps == 8 and hist.n_syncs == 8, f"{steps} steps, "
          f"{hist.n_syncs} communication events")
    check(all(d == 0.0 for d in probe.max_diff), "replicas diverged")
    check(out["launches"] == want, f"launches {out['launches']} != {want}")
    out["W"] = engine.W
    del engine
    return out


# ------------------------------------------------------------------ phase 6
def check_sync_launches(launches: dict, n_syncs: int,
                        n_leaves: int = N_LEAVES) -> None:
    """A periodic path (OLMo-1B unless ``n_leaves`` says otherwise): one
    mean_and_sqdev launch per sync, covering all of W's leaves; no other
    kernel."""
    want = dict(dict.fromkeys(COUNTS, 0), mean_and_sqdev=n_syncs,
                **{LEAVES: n_leaves * n_syncs})
    check(launches == want, f"launches {launches} != {want}")


def phase_clock(main_path: dict) -> dict:
    """The telemetry clock on phase 3's path (OLMo-1B full width, 4
    layers, R = 4, 16 ADPSGD steps), through the CLI's ``--net``.

    (a) ``--net 10gbps``: sync steps, losses and S_k bit-identical to
        phase 3's unclocked run; one Timeline record per program run;
        sim_wall_s = 16 × 5 ms + Σ comm_s; bytes per ``all_mean`` =
        ``all_mean_op().wire_bytes(371_458_048, 4, n_tensors=29)``.
    (b) ``--net real``: the WallClock's records sum to no more than the
        run's host wall time; the share they leave is printed (host work
        between programs, the variance probe, the batches).
    (c) ``--net real --wallclock-sample-every 4`` (programs not bracketed
        by the script's synchronisations): ``n_blocks`` equals the
        programs run on sampled steps, and each closed window's records
        sum to the real time it spans.
    Each run launches mean_and_sqdev once per sync over its 29 leaves and
    nothing else."""
    from repro_torch.backends.ops import all_mean_op

    out = drive(MAIN_ARGV + ["--net", "10gbps"])
    engine, hist = out.pop("engine"), out.pop("hist")
    check_sync_launches(out["launches"], hist.n_syncs)
    t = hist.timing
    want_steps, want_losses, want_sk = main_path["trajectory"]
    per_sync = (t["by_program"]["all_mean"]["bytes"]
                / t["by_program"]["all_mean"]["calls"])
    want_bytes = all_mean_op().wire_bytes(N_PARAMS, 4, n_tensors=N_LEAVES)
    n_programs = sum(out["calls"].values())
    print(f"  (a) 10gbps: sim_wall_s={t['sim_wall_s']!r} compute_s="
          f"{t['compute_s']!r} comm_s={t['comm_s']!r} records="
          f"{t['n_records']} programs={n_programs} bytes/all_mean="
          f"{per_sync!r} (want {want_bytes!r}); identical to phase 3: "
          f"sync_steps={hist.sync_steps == want_steps} "
          f"losses={hist.losses == want_losses} s_k={hist.s_k == want_sk}")
    check(hist.sync_steps == want_steps and hist.losses == want_losses
          and hist.s_k == want_sk, "the clocked run differs from phase 3")
    check(t["n_records"] == n_programs == len(engine.timeline.records),
          f"{t['n_records']} records for {n_programs} programs")
    check(math.isclose(t["sim_wall_s"], 16 * 5e-3 + t["comm_s"],
                       rel_tol=1e-12), "sim_wall_s != 16 x 5 ms + comm_s")
    check(per_sync == want_bytes, f"all_mean bytes {per_sync} != {want_bytes}")
    sim = {"sim_wall_s": t["sim_wall_s"], "comm_s": t["comm_s"],
           "bytes_per_all_mean": per_sync}
    launches = out["launches"]
    del engine, hist      # hist holds the final W and optimizer state
    release()

    out = drive(MAIN_ARGV + ["--net", "real"])
    engine, hist = out.pop("engine"), out.pop("hist")
    check_sync_launches(out["launches"], hist.n_syncs)
    t = hist.timing
    recs = engine.timeline.records
    step_ms = statistics.median(r.compute_s * 1e3 for r in recs
                                if r.name == "replica_step")
    sync_ms = statistics.median(r.comm_s * 1e3 for r in recs
                                if r.name == "all_mean")
    uncovered = 1.0 - t["total_s"] / hist.wall_s
    print(f"  (b) real: records sum {t['total_s']!r} s of host wall "
          f"{hist.wall_s!r} s, uncovered share {uncovered!r}; WallClock "
          f"median step {step_ms!r} ms, median sync {sync_ms!r} ms "
          f"(card: {card_line()})")
    check(t["total_s"] <= hist.wall_s, "WallClock records exceed the run")
    check(engine.clock.n_blocks == len(recs), "a program was not waited for")
    wall = {"step_ms": step_ms, "sync_ms": sync_ms, "wall_s": hist.wall_s,
            "records_s": t["total_s"], "uncovered_share": uncovered}
    launches = {k: launches[k] + out["launches"][k] for k in launches}
    del engine, hist      # hist holds the final W and optimizer state
    release()

    windows = []

    def check_windows(engine):
        """Record (records' sum, elapsed) of every window a sample closes."""
        clock = engine.clock
        measure = clock.measure

        def checked(name, fn, args, **kw):
            window, mark = list(clock._window), clock._mark
            res = measure(name, fn, args, **kw)
            last = clock.timeline.last
            if window and not last.interpolated:
                got = sum(r.compute_s + r.comm_s for r, _ in window) \
                    + last.compute_s + last.comm_s
                windows.append((got, clock._mark - mark))
            return res
        clock.measure = checked

    out = drive(MAIN_ARGV + ["--net", "real", "--wallclock-sample-every",
                             "4"], setup=check_windows, time_programs=False)
    engine, hist = out.pop("engine"), out.pop("hist")
    check_sync_launches(out["launches"], hist.n_syncs)
    recs = engine.timeline.records
    on_sampled = sum(1 for r in recs if r.step % 4 == 0)
    print(f"  (c) real, sampled every 4: n_blocks={engine.clock.n_blocks} "
          f"programs on sampled steps={on_sampled} of {len(recs)}; windows "
          f"(records, elapsed) s: {windows}")
    check(engine.clock.n_blocks == on_sampled, "n_blocks != sampled programs")
    check(all(r.interpolated == bool(r.step % 4) for r in recs),
          "interpolated flags do not follow the sampled steps")
    check(len(windows) == 3 and all(
        math.isclose(a, b, rel_tol=1e-9) for a, b in windows),
        "a window's records do not sum to its elapsed time")
    check(hist.sync_steps == want_steps and hist.losses == want_losses,
          "the sampled run differs from phase 3")
    launches = {k: launches[k] + out["launches"][k] for k in launches}
    del engine, hist      # hist holds the final W and optimizer state
    release()
    return {"launches": launches, "sim": sim, "wall": wall,
            "windows": windows}


# ------------------------------------------------------------------ phase 7
def phase_strategies() -> dict:
    """hier_adpsgd, dasgd and adacomm (time blocks) on phase 3's model,
    16 steps each.

    hier_adpsgd --inner-period 2 (groups of 2): after every inner sync
    the replicas of each group are bit-identical on the embedding and two
    more leaves; inner_sync_steps follow the controller's rule; one
    mean_and_sqdev launch over the 29 leaves per outer sync, none for the
    inner ones.
    dasgd --p-const 4 (delay 2): each S_k is recorded at its snapshot
    step, equals a plain recomputation from W taken at the end of that
    step (rtol 1e-4), and its correction is applied exactly 2 steps
    later; one launch over the 29 leaves per warm-up sync and per
    snapshot; the snapshot (``mean_delta``) is timed on the final W beside
    its per-leaf route and its bound.
    adacomm --adacomm-mode time --net 10gbps --adacomm-t0 2.0: the
    schedule on the SimulatedClock; at every block boundary after the
    calibration block the period is the controller's rule, recomputed
    here from the block's losses; one launch over 29 leaves per sync."""
    import torch
    from repro_torch.kernels.ref import mean_and_sqdev_ref
    from repro_torch.runtime.engine import Callback
    from repro_torch.tree import tree_leaves

    results = {}
    inner_checks = []

    def hier_wrap(engine, name, fn):
        if name != "inner_sync":
            return fn

        def inner(W, opt_state, batch, lr, key):
            res = fn(W, opt_state, batch, lr, key)
            leaves = tree_leaves(res[0])
            embed = max(leaves, key=lambda x: x.numel())
            same = all(torch.equal(x[0], x[1]) and torch.equal(x[2], x[3])
                       for x in (embed, leaves[1], leaves[-1]))
            apart = not torch.equal(embed[0], embed[2])
            inner_checks.append((same, apart))
            return res
        return inner

    out = drive(HIER_ARGV, wrap=hier_wrap)
    engine, hist = out.pop("engine"), out.pop("hist")
    rule, cnt = [], 0
    for k in range(len(hist.losses)):
        if k in hist.sync_steps:
            cnt = 0
        else:
            cnt += 1
            if cnt >= 2:
                cnt = 0
                rule.append(k)
    print(f"  hier_adpsgd: inner_sync_steps={hist.inner_sync_steps} (rule "
          f"{rule}); groups identical / apart after each inner sync: "
          f"{inner_checks}")
    check(hist.inner_sync_steps == rule and rule,
          "inner syncs do not follow the controller's rule")
    check(all(same and apart for same, apart in inner_checks),
          "a group's replicas differ after an inner sync")
    check_sync_launches(out["launches"], hist.n_syncs)
    results["hier_adpsgd"] = {k: out[k] for k in ("launches", "ms", "calls")}
    results["hier_adpsgd"]["inner_sync_steps"] = hist.inner_sync_steps
    results["hier_adpsgd"]["mesh_ref"] = dict(resume_ref(engine, hist),
                                              ms=out["ms"])
    del engine, hist      # hist holds the final W and optimizer state
    release()

    class PlainAtSnapshot(Callback):
        def __init__(self):
            self.plain = {}

        def on_iteration_end(self, engine, k, metrics):
            if engine.strategy._snap_at == k:
                with torch.no_grad():
                    leaves = tree_leaves(engine.W)
                    self.plain[k] = float(
                        sum(mean_and_sqdev_ref(x)[1] for x in leaves)
                        / leaves[0].shape[0])

    acts = {}

    def record_actions(engine):
        actions = engine.strategy.actions

        def spy(k):
            acts[k] = actions(k)
            return acts[k]
        engine.strategy.actions = spy

    probe = PlainAtSnapshot()
    out = drive(DASGD_ARGV, callbacks=[probe], setup=record_actions)
    engine, hist = out.pop("engine"), out.pop("hist")
    snaps = [k for k, a in acts.items() if "sync" in a]
    applies = [k for k, a in acts.items() if "sync_apply" in a]
    at = dict(zip(hist.sync_steps, hist.s_k))
    rels = [abs(at[k] - probe.plain[k]) / probe.plain[k] for k in snaps]
    print(f"  dasgd: sync_steps={hist.sync_steps} snapshots={snaps} "
          f"applies={applies}; fetched S_k vs plain at the snapshot step "
          f"rel={rels}")
    check(len(snaps) >= 3 and applies == [k + 2 for k in snaps],
          "corrections not applied 2 steps after their snapshots")
    check(set(snaps) <= set(hist.sync_steps), "S_k not at its snapshot step")
    check(all(r <= 1e-4 for r in rels), "fetched S_k differs from plain")
    check_sync_launches(out["launches"], hist.n_syncs)
    results["dasgd"] = {k: out[k] for k in ("launches", "ms", "calls",
                                            "peak_bytes")}
    results["dasgd"]["s_k_rel"] = rels
    results["dasgd"]["resume_ref"] = dict(resume_ref(engine, hist),
                                          snaps=snaps, applies=applies,
                                          ms=out["ms"])
    results["dasgd"]["snapshot_timing"] = snapshot_timing(engine.backend,
                                                          engine.W)
    del engine, hist      # hist holds the final W and optimizer state
    release()

    blocks = []

    def record_blocks(engine):
        ctl = engine.strategy.controller
        observe = ctl.observe_loss

        def spy(k, loss):
            f0, n = ctl.f0, ctl._loss_n
            observe(k, loss)
            if ctl._loss_n == 0:                    # the block closed at k
                blocks.append((k, n + 1, f0, ctl.f0, ctl.tau))
        ctl.observe_loss = spy

    out = drive(ADACOMM_ARGV, setup=record_blocks)
    engine, hist = out.pop("engine"), out.pop("hist")
    t = hist.timing
    print(f"  adacomm (time, 10gbps, t0 2.0 s): sync_steps={hist.sync_steps} "
          f"periods={hist.period_history} sim_wall_s={t['sim_wall_s']!r}")
    check(hist.n_syncs >= 3 and t["clock"] == "sim", "adacomm did not run")
    ctl = engine.strategy.controller
    ratios = []
    for k, n, f0_before, f0, tau in blocks:
        total = 0.0
        for v in hist.losses[k + 1 - n:k + 1]:
            total += v
        f = total / n
        if f0_before is None:
            check(f0 == f, f"calibration block F0 {f0!r} != {f!r}")
            continue
        ratio = (ctl.tau0 * math.sqrt(max(f, 0.0) / f0)
                 / math.sqrt(max(1.0, engine.clock.straggler_factor())))
        want = min(max(math.ceil(ratio), ctl.cfg.p_min), ctl.cfg.p_max)
        ratios.append(ratio)
        check(tau == want, f"block ending at {k}: tau {tau} != {want}")
    print(f"  adacomm blocks (end step, steps): "
          f"{[(k, n) for k, n, *_ in blocks]}; tau0*sqrt(F/F0) after "
          f"calibration: {ratios}")
    check(ratios, "no block closed after the calibration block")
    check_sync_launches(out["launches"], hist.n_syncs)
    results["adacomm"] = {k: out[k] for k in ("launches", "ms", "calls")}
    results["adacomm"]["periods"] = hist.period_history
    del engine, hist      # hist holds the final W and optimizer state
    release()
    return results


# ------------------------------------------------------------------ phase 8
def cnn_plain_s_k(strategy, W, key) -> float:
    """The plain route's S_k of the sync about to run on W: the plain
    mean_and_sqdev summed over the leaves, or, for qsgd_periodic's
    quantized sync, the plain backend's exchange on copies of W, the
    anchor and the key (phase 3b's comparison)."""
    import torch
    from repro_torch.backends import VmapBackend
    from repro_torch.kernels.ref import mean_and_sqdev_ref
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_leaves(W)
    anchor = getattr(strategy, "_anchor", None)
    with torch.no_grad():
        if anchor is None:
            return float(sum(mean_and_sqdev_ref(x)[1] for x in leaves)
                         / leaves[0].shape[0])
        plain = VmapBackend(use_kernel=False, device=leaves[0].device)
        return float(plain.quantized_all_mean(strategy.cfg.qsgd_bits)(
            tree_map(torch.clone, W), tree_map(torch.clone, anchor), key)[2])


def cnn_run(name: str, net: str, params0, data) -> tuple:
    """One of ``benchmarks/common.py``'s runs, built from the port's
    modules: R = 8, batch 16, 60 steps, momentum, lr 0.05 decayed at 30
    and 45, warm-up 4, p_init 4, p_const 8, decreasing (20, 5),
    inner_period 2, track_variance_every 2, SimulatedClock at 5 ms per
    step.  Every sync's S_k is held against the plain route's on the W
    it synced (rtol 1e-4, as phase 3).  Returns (timed columns, launches,
    history, timeline)."""
    from repro_torch.configs import AveragingConfig
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.optim import get_optimizer, make_lr_schedule
    from repro_torch.runtime.clock import SimulatedClock
    from repro_torch.runtime.engine import TrainerEngine

    steps = CNN_STEPS
    cfg = AveragingConfig(
        method=name, p_init=4, p_const=8, k_sample_frac=0.25,
        warmup_full_sync_steps=4, decreasing_p0=20, decreasing_p1=5,
        inner_period=2)
    engine = TrainerEngine(
        loss_fn=cnn_loss, optimizer=get_optimizer("momentum"),
        params0=params0, n_replicas=CNN_R,
        data_fn=data.batches(n_replicas=CNN_R, per_replica_batch=16,
                             device=DEVICE),
        lr_fn=make_lr_schedule("step", 0.05, steps,
                               decay_steps=(steps // 2, 3 * steps // 4)),
        avg_cfg=cfg, total_steps=steps,
        clock=SimulatedClock(net, step_compute_s=5e-3),
        track_variance_every=2, device=DEVICE)
    plain = []
    programs = engine.strategy.programs
    for prog in ("sync", "full_sync"):
        if prog in programs:
            def probed(W, opt_state, batch, lr, key, fn=programs[prog]):
                plain.append(cnn_plain_s_k(engine.strategy, W, key))
                return fn(W, opt_state, batch, lr, key)
            programs[prog] = probed
    reset_counts()
    hist = engine.run()
    launches = read_counts()
    # a DaSGD snapshot still in flight at the end is never fetched
    check(len(plain) - len(hist.s_k) in ((0, 1) if name == "dasgd" else (0,)),
          f"{name}/{net}: {len(plain)} syncs probed, {len(hist.s_k)} S_k")
    rels = [abs(a - b) / abs(b) if b else abs(a)
            for a, b in zip(hist.s_k, plain)]
    worst = max(rels, default=0.0)
    check(worst <= 1e-4, f"{name}/{net}: S_k differs from plain, max rel "
                         f"{worst}")
    t = hist.timing
    cols = {
        "sim_wall_s": round(t["sim_wall_s"], 6),
        "sim_compute_s": round(t["compute_s"], 6),
        "sim_comm_s": round(t["comm_s"], 6),
        "comm_bytes_per_node": round(t["bytes"], 1),
        "wire_bytes": {p: round(v["bytes"] / v["calls"], 1)
                       for p, v in sorted(t["by_program"].items())
                       if v["bytes"]},
        "n_syncs": hist.n_syncs,
        "final_loss": round(float(statistics.fmean(hist.losses[-8:])), 4),
        "s_k_max_rel": worst,
    }
    return cols, launches, hist, engine.timeline


def cnn_card_vs_cpu(params, batch) -> float:
    """cnn_loss and its gradients on the card (cuDNN convolutions on
    permuted channels-last views, TF32 off) against the port's CPU route,
    which the tests hold against the reference, on the same parameters
    and batch.  Loss rtol 1e-5; each leaf's gradient within 1e-4 of its
    largest CPU value (f32 sums over up to 16 x 32 x 32 terms in another
    order).  Returns the largest gradient error relative to its leaf."""
    from repro_torch.core.averaging import value_and_grad
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.tree import tree_leaves, tree_map

    loss, _, grads = value_and_grad(cnn_loss, params, batch)
    cpu = tree_map(lambda x: x.detach().cpu(), params)
    loss_c, _, grads_c = value_and_grad(
        cnn_loss, cpu, {k: v.cpu() for k, v in batch.items()})
    loss_rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    rels = [float((g.cpu() - gc_).abs().max() / gc_.abs().max())
            for g, gc_ in zip(tree_leaves(grads), tree_leaves(grads_c))]
    print(f"    loss card={float(loss)!r} cpu={float(loss_c)!r} "
          f"rel={loss_rel:.3e}; grad max err / leaf max per leaf="
          f"{[f'{r:.2e}' for r in rels]}")
    check(loss_rel <= 1e-5, f"CNN loss on the card: rel {loss_rel}")
    check(max(rels) <= 1e-4, f"CNN gradients on the card: rel {max(rels)}")
    return max(rels)


def cnn_launches_expected(name: str, by_program: dict) -> dict:
    """mean_and_sqdev once over all leaves of every all_mean and
    mean_delta, once per leaf of every quantized_all_mean; QSGD's kernels
    per quantized exchange (sqnorm once per leaf over its replicas,
    quantize / dequantize per leaf and replica) and per qsgd step (sqnorm
    once per replica)."""
    calls = {p: v["calls"] for p, v in by_program.items()}
    grouped = calls.get("all_mean", 0) + calls.get("mean_delta", 0)
    q = calls.get("quantized_all_mean", 0)
    s = calls.get("qsgd_step", 0)
    want = dict.fromkeys(COUNTS, 0)
    want["mean_and_sqdev"] = grouped + CNN_LEAVES * q
    want[LEAVES] = CNN_LEAVES * (grouped + q)
    want["sqnorm"] = CNN_LEAVES * q + CNN_R * s
    want["quantize"] = want["dequantize"] = CNN_LEAVES * CNN_R * (q + s)
    return want


def phase_cnn() -> dict:
    """The paper's CNN experiment: all nine strategies at 10 and 100 Gbps
    beside ``BENCH_engine.json``'s ``timed`` columns.  The five whose
    schedule depends on neither losses nor S_k (fullsgd, cpsgd,
    decreasing, dasgd, qsgd) must equal the recorded columns at the
    JSON's rounding (final_loss aside); ADPSGD's speedup over FULLSGD
    must be larger at 10 Gbps than at 100 Gbps, and above 1 at both.
    The parameters start from the reference's init (``init_cnn(0)``
    draws jax's normals to a few ulps); the adaptive four are printed,
    not checked.  Every sync runs mean_sqdev.cu, the QSGD pair
    qsgd_quant.cu; launches are checked per strategy and every S_k
    against the plain route.  The loss and gradients on the card are held
    against the CPU route at the init and at FULLSGD's final replica 0.
    FULLSGD from three more seeds shows how the setting's step-1
    overshoot ends (printed).  FULLSGD's final W is bitwise equal at 10
    and 100 Gbps: the same program from the same init, with deterministic
    convolutions."""
    import torch
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.models.cnn import init_cnn
    from repro_torch.strategies import available_strategies
    from repro_torch.tree import tree_leaves, tree_map

    recorded = json.loads((ROOT / "BENCH_engine.json").read_text())
    check(recorded["config"] == {"base_lr": 0.05, "n_replicas": CNN_R,
                                 "per_replica_batch": 16,
                                 "sim_step_compute_s": 0.005,
                                 "steps": CNN_STEPS},
          f"BENCH_engine.json config {recorded['config']}")
    data = SyntheticImages(n_samples=2048, seed=0)
    params0 = init_cnn(0, widths=(16, 32), device=DEVICE)
    n_params = sum(x.numel() for x in tree_leaves(params0))
    print(f"  CNN widths (16, 32): params={n_params} "
          f"leaves={len(tree_leaves(params0))} R={CNN_R} steps={CNN_STEPS}")
    check(n_params == 532_202 and len(tree_leaves(params0)) == CNN_LEAVES,
          "CNN size")
    batches = data.batches(n_replicas=CNN_R, per_replica_batch=16,
                           device=DEVICE)
    print("  card vs CPU route at the init, batch of step 0:")
    grad_rel = cnn_card_vs_cpu(
        params0, {k: v[0] for k, v in batches(0).items()})
    names = available_strategies()
    check(sorted(names) == sorted(recorded["strategies"]),
          "strategies differ from BENCH_engine.json's")
    table, launches_all, wall = {}, dict.fromkeys(COUNTS, 0), {}
    fullsgd_W = {}
    for net in ("10gbps", "100gbps"):
        cols = {}
        for name in names:
            t0 = time.perf_counter()
            c, launches, hist, tl = cnn_run(name, net, params0, data)
            wall[(name, net)] = time.perf_counter() - t0
            want = cnn_launches_expected(name, tl.by_program)
            check(launches == want,
                  f"{name}/{net} launches {launches} != {want}")
            check(all(math.isfinite(x) for x in hist.losses),
                  f"{name}/{net}: non-finite loss")
            c["launches"] = launches
            cols[name] = c
            for k in COUNTS:
                launches_all[k] += launches[k]
            if name == "fullsgd" and net == "10gbps":
                print("  card vs CPU route at FULLSGD's final replica 0, "
                      f"batch of step {CNN_STEPS - 1}:")
                grad_rel = max(grad_rel, cnn_card_vs_cpu(
                    tree_map(lambda x: x[0], hist.final_W),
                    {k: v[0] for k, v in batches(CNN_STEPS - 1).items()}))
                c["step1_loss"] = hist.losses[1]
            if name == "fullsgd":
                fullsgd_W[net] = tree_leaves(hist.final_W)
            if name == "adpsgd" and net == "10gbps":
                adpsgd_W = hist.final_W
            del hist
        full = cols["fullsgd"]["sim_wall_s"]
        for c in cols.values():
            c["speedup_vs_fullsgd"] = round(full / c["sim_wall_s"], 4)
        table[net] = cols
    keys = ("n_syncs", "sim_comm_s", "sim_wall_s", "comm_bytes_per_node",
            "wire_bytes", "speedup_vs_fullsgd")
    for net in ("10gbps", "100gbps"):
        print(f"  {net}: strategy: port | recorded "
              f"({', '.join(keys)}, final_loss), launches, host s")
        for name in sorted(names):
            got, rec = table[net][name], recorded["strategies"][name]["timed"][net]
            print(f"    {name}: {[got[k] for k in keys]} {got['final_loss']}"
                  f" | {[rec[k] for k in keys]} {rec['final_loss']}  "
                  f"{got['launches']} {wall[(name, net)]:.3f} S_k max rel "
                  f"{got['s_k_max_rel']:.2e}")
    for name in ("fullsgd", "cpsgd", "decreasing", "dasgd", "qsgd"):
        for net in ("10gbps", "100gbps"):
            got, rec = table[net][name], recorded["strategies"][name]["timed"][net]
            diff = [k for k in keys + ("sim_compute_s",) if got[k] != rec[k]]
            check(not diff, f"{name}/{net} differs from BENCH_engine.json "
                            f"in {diff}")
    # the clock never touches the numerics, and the convolutions are
    # deterministic (cudnn.deterministic): one program from one init
    same = [torch.equal(a, b) for a, b in zip(fullsgd_W["10gbps"],
                                              fullsgd_W["100gbps"])]
    print(f"  FULLSGD final W at 10gbps and 100gbps bitwise equal per leaf: "
          f"{same}; final_loss {table['10gbps']['fullsgd']['final_loss']} / "
          f"{table['100gbps']['fullsgd']['final_loss']}")
    check(all(same), "FULLSGD's final W differs between the two clocks")
    del fullsgd_W
    s10 = table["10gbps"]["adpsgd"]["speedup_vs_fullsgd"]
    s100 = table["100gbps"]["adpsgd"]["speedup_vs_fullsgd"]
    print(f"  ADPSGD speedup over FULLSGD: 10gbps {s10} > 100gbps {s100} "
          f"> 1: {s10 > s100 > 1}")
    check(s10 > s100 > 1, "ADPSGD's speedup does not grow as the link slows")
    sweep = {0: (table["10gbps"]["fullsgd"]["step1_loss"],
                 table["10gbps"]["fullsgd"]["final_loss"])}
    for seed in (1, 2, 3):
        c, _, hist, _ = cnn_run("fullsgd", "10gbps",
                                init_cnn(seed, widths=(16, 32),
                                         device=DEVICE), data)
        sweep[seed] = (hist.losses[1], c["final_loss"])
        del hist
    print("  FULLSGD at lr 0.05 by init seed: (step-1 loss, final loss) "
          + json.dumps(sweep))
    W = [x.cpu() for x in tree_leaves(adpsgd_W)]
    del adpsgd_W
    release()
    return {"launches": launches_all, "table": table, "seed_sweep": sweep,
            "grad_rel": grad_rel, "W": W,
            "host_s": {f"{n}/{net}": v for (n, net), v in wall.items()}}


def main_cnn() -> int:
    """``--cnn PATH``: phase 8 in a process of its own on the card (the
    script starts it beside phase 9): its results as JSON on the last
    line, ADPSGD's final W (10 Gbps) to PATH."""
    import torch
    path = sys.argv[sys.argv.index("--cnn") + 1]
    set_numerics()
    out = phase_cnn()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.save(out.pop("W"), path)
    print(json.dumps(out, default=str))
    return 0


def start_cnn(path: str) -> dict:
    """Start phase 8 (``--cnn``) on the card; ``finish_cnn`` collects it."""
    import os
    return start_job([str(ROOT / "chip_smoke.py"), "--cnn", path],
                     dict(os.environ, PYTHONPATH=str(ROOT / "src")))


# beyond its max_memory_allocated, each process started beside phase 9 holds
# its CUDA context and, in the CLI runs, NCCL's buffers
CONTEXT_BYTES = 2**30
CNN_BYTES = 2**30       # phase 8's CNN: widths 16 and 32, 16 images a replica


def co_resident_check(main_path: dict, strategies: dict) -> dict:
    """Phase 9 shares the card with phase 8 and phases 15 and 15b's CLI
    runs.  Fail unless the card's free memory holds what the four may take
    together: phase 9's resumed runs at their peaks in phases 3 and 7
    (dasgd); each CLI run (phase 3's model on the mesh, 4 steps) at phase
    3's peak and 10 % (the mesh's buckets: +5 % in phase 15); the CNN; a
    context each for the three new processes."""
    import torch
    free, total = torch.cuda.mem_get_info()
    p3 = main_path["peak_bytes"]
    need = {"phase 9": max(p3, strategies["dasgd"]["peak_bytes"]),
            "CLI runs": 2 * int(1.1 * p3), "phase 8": CNN_BYTES,
            "contexts": 3 * CONTEXT_BYTES}
    print(f"  beside phase 9 on the card: needs {need} B, together "
          f"{sum(need.values())} B; free {free} of {total} B")
    check(sum(need.values()) <= free,
          "the card cannot hold phase 9 and the three processes beside it")
    return dict(need, free=free)


def least_free(every: float = 0.2):
    """Sample the card's free memory over every process
    (``torch.cuda.mem_get_info``) every ``every`` s in a thread; the
    function returned stops it and gives the least seen (bytes)."""
    import threading
    import torch
    stop, seen = threading.Event(), [torch.cuda.mem_get_info()[0]]

    def sample():
        while not stop.wait(every):
            seen.append(torch.cuda.mem_get_info()[0])

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()

    def end() -> int:
        stop.set()
        thread.join()
        return min(seen)
    return end


def finish_cnn(job: dict, path: str) -> dict:
    """Phase 8's process: its output printed, exit 0, its result; then,
    in this process (the card its own again: call it after the other card
    jobs have ended), the grouped kernel against the plain
    version on ADPSGD's final W and one sync of it timed."""
    import torch
    rc, stdout, stderr, wall = finish_cpu_job(job)
    lines = stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln)
    print(f"  phase 8 ran in a process of its own: exit {rc}, collected "
          f"{wall:.1f} s after its start")
    check(rc == 0, "phase 8 failed:\n" + stdout[-3000:] + stderr[-3000:])
    out = json.loads(lines[-1])
    print(f"  phase 8's max_memory_allocated={out['peak_bytes']} B "
          f"({out['peak_bytes'] / 2**30:.2f} GiB)")
    W = [x.to(DEVICE) for x in torch.load(path)]
    out["grouped"] = check_grouped_on_W(W, "CNN W (adpsgd, 10gbps)", 34)
    out["timing"] = phase_timing(W)
    del W
    release()
    return out


# ------------------------------------------------------------------ phase 9
def resume_check(label: str, argv, split: int, ref: dict) -> dict:
    """Run ``argv`` for ``split`` steps through the training CLI's setup,
    save a checkpoint (``Checkpointer.save``) into a fresh temporary
    directory, build a second engine through the same setup, load the
    checkpoint onto the host and install it (``load_state`` copies each
    leaf once onto the card, so the load holds less than half the
    checkpoint's bytes on the card above the fresh engine's) and run the
    remaining steps.  The two
    segments' histories must reassemble ``ref`` (the uninterrupted run of
    an earlier phase) exactly, the final W must equal its W bitwise, and
    the resumed segment launches mean_and_sqdev once over the 29 leaves
    per sync it counts.  Prints the free space at the start, the checkpoint's bytes
    on disk and the save and load seconds; the directory is removed
    afterwards."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.io import load_checkpoint
    from repro_torch.launch import train
    from repro_torch.runtime.engine import Checkpointer
    from repro_torch.tree import tree_leaves

    args = train.parse_args(argv)
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        release()
        engine, _ = train.build_engine(args)
        first = engine.run(num_steps=split)
        in_flight = getattr(engine.strategy, "_apply_at", None)
        state = [engine.W, engine.opt_state]
        if in_flight is not None:
            state.append(engine.W)              # the f32 correction
        need = sum(x.numel() * 4 for x in tree_leaves(state))
        free = shutil.disk_usage(path).free
        print(f"  {label}: {split} steps, then a checkpoint into {path}: "
              f"{free} B free, about {need} B needed; correction in "
              f"flight: {in_flight is not None} (due at step {in_flight})")
        check(free >= need + 2**30,
              f"{path} has {free} B free; the checkpoint needs about {need} "
              f"B (set TMPDIR to a larger disk)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Checkpointer(path, every=split).save(engine, split)
        save_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        on_disk = sum(files.values())
        names = ("losses", "sync_steps", "period_history", "s_k")
        seg = {k: list(getattr(first, k)) for k in names}
        seg["n_syncs"] = first.n_syncs
        del engine, first, state
        release()

        engine, _ = train.build_engine(args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        W, opt_state, meta = load_checkpoint(path, "cpu")
        read_s = time.perf_counter() - t0
        engine.load_state(W, opt_state, strategy_state=meta["controller"],
                          clock_state=meta.get("clock"))
        del W, opt_state
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - base
        print(f"  {label}: card memory above the fresh engine's while "
              f"loading: {load_peak} B (the checkpoint: {on_disk} B)")
        check(load_peak < on_disk / 2,
              f"{label}: the load held {load_peak} B more on the card")
        reset_counts()
        hist = engine.run(start_step=split)
        launches = read_counts()
        torch.cuda.synchronize()
        print(f"  {label}: checkpoint {on_disk} B on disk "
              f"({on_disk / 2**30:.2f} GiB) {files}; save {save_s:.3f} s "
              f"({on_disk / save_s / 1e9:.3f} GB/s), load_checkpoint "
              f"{read_s:.3f} s, with load_state {load_s:.3f} s; meta step "
              f"{meta['step']} controller "
              f"{ {k: v for k, v in meta['controller'].items() if k != '_arrays'} }")
        print(f"  {label}: resumed losses={hist.losses}")
        print(f"  {label}: resumed sync_steps={hist.sync_steps} periods="
              f"{hist.period_history} s_k={hist.s_k} n_syncs={hist.n_syncs} "
              f"launches={launches}")
        same_W = [torch.equal(a.cpu(), b) for a, b in
                  zip(tree_leaves(engine.W), ref["W"])]
        same = {k: seg[k] + list(getattr(hist, k)) == ref[k] for k in names}
        same.update(n_syncs=seg["n_syncs"] + hist.n_syncs == ref["n_syncs"],
                    W=len(same_W) == len(ref["W"]) and all(same_W))
        print(f"  {label}: both segments together bit-identical to the "
              f"uninterrupted run: {same}")
        check(all(same.values()), f"{label}: the resumed run differs: {same}")
        check(meta["step"] == split, f"{label}: meta step {meta['step']}")
        check_sync_launches(launches, hist.n_syncs)
        out = {"launches": launches, "bytes_on_disk": on_disk,
               "save_s": save_s, "read_s": read_s, "load_s": load_s,
               "load_peak_bytes": load_peak, "free_bytes": free,
               "in_flight": in_flight is not None,
               "tail_syncs": hist.n_syncs}
        del engine, hist
        return out
    finally:
        shutil.rmtree(path, ignore_errors=True)
        release()


def phase_resume(main_ref: dict, dasgd_ref: dict) -> dict:
    """(a) phase 3's ADPSGD run split 8 + save + 8; (b) phase 7's dasgd
    run saved between its first steady-state snapshot and that snapshot's
    apply (a correction in flight), resumed to the end."""
    out = {"adpsgd": resume_check("9a adpsgd", MAIN_ARGV, RESUME_AT,
                                  main_ref)}
    snap = dasgd_ref["snaps"][0]
    split = snap + 1
    print(f"  9b dasgd: phase 7's snapshots {dasgd_ref['snaps']} applies "
          f"{dasgd_ref['applies']}; saving after step {snap}, before the "
          f"apply at {snap + 2}: split at {split}")
    out["dasgd"] = resume_check("9b dasgd", DASGD_ARGV, split, dasgd_ref)
    check(out["dasgd"]["in_flight"], "9b: no correction in flight")
    out["dasgd"]["split"] = split
    out["launches"] = {k: out["adpsgd"]["launches"][k]
                       + out["dasgd"]["launches"][k] for k in COUNTS}
    return out


# ----------------------------------------------------------------- phase 15
def on_mesh(argv, steps=None):
    """``argv`` with ``--backend mesh`` (and ``steps`` steps if given)."""
    argv = list(argv)
    argv[argv.index("--backend") + 1] = "mesh"
    if steps is not None:
        argv[argv.index("--steps") + 1] = str(steps)
    return argv


class Collectives:
    """Every ``torch.distributed`` collective call while installed, with
    its op and the bytes of the tensor handed to it, in ``calls``, and the
    group it was given in ``groups``."""

    OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
           "broadcast", "reduce_scatter", "reduce", "gather", "scatter",
           "all_to_all", "barrier")

    def __init__(self):
        import torch
        import torch.distributed as dist
        self.calls, self.groups, self._orig = [], [], {}
        for op in self.OPS:
            fn = getattr(dist, op, None)
            if fn is None:
                continue
            self._orig[op] = fn

            def call(*a, _op=op, _fn=fn, **kw):
                t = (a[1] if _op in ("all_gather", "all_gather_into_tensor")
                     else (a[0] if a else None))
                self.calls.append((_op, t.numel() * t.element_size()
                                   if isinstance(t, torch.Tensor) else 0))
                self.groups.append(kw.get("group"))
                return _fn(*a, **kw)
            setattr(dist, op, call)

    def close(self) -> None:
        import torch.distributed as dist
        for op, fn in self._orig.items():
            setattr(dist, op, fn)


def group_of(mesh, group) -> str:
    """'data', 'model' or 'world' for a group of ``mesh`` (None: the
    world; at model size 1 the data group is the world, named 'data')."""
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        group = mesh.group
    if group is mesh.data_group:
        return "data"
    if group is mesh.model_group:
        return "model"
    return "world" if group is mesh.group else "sub"


def mesh_run(label: str, argv, ref: dict, tp: bool = False) -> dict:
    """``argv`` on the mesh through ``drive``, each program's collective
    calls recorded with their groups (the metrics mean apart); its
    history and final W held to the vmap run ``ref`` bit for bit.  Under
    ``replica_tp`` (``tp``) the first local step's DTensor collectives
    are counted too (``CommDebugMode``)."""
    import torch
    from repro_torch.tree import tree_leaves

    log, dtensor = [], []
    counter = Collectives()

    def wrap(engine, name, fn):
        backend = engine.backend
        if not hasattr(backend, "_tagged"):
            backend._tagged = [0]
            metrics_mean = backend._metrics_mean

            def tagged(m):
                backend._tagged[0] += 1
                return metrics_mean(m)
            backend._metrics_mean = tagged

        def run(*a):
            before, tag = len(counter.calls), backend._tagged[0]
            if tp and name == "step" and not dtensor:
                # the first step alone: the mode wraps every op
                from torch.distributed.tensor.debug import CommDebugMode
                with CommDebugMode() as comms:
                    out = fn(*a)
                dtensor.append({str(k): v for k, v in
                                comms.get_comm_counts().items()
                                if "functional" in str(k)})
            else:
                out = fn(*a)
            log.append((name, counter.calls[before:],
                        backend._tagged[0] - tag,
                        [group_of(backend.mesh, g)
                         for g in counter.groups[before:]]))
            return out
        return run

    try:
        out = drive(argv, wrap=wrap)
    finally:
        counter.close()
    engine, hist = out.pop("engine"), out.pop("hist")
    W = [x.cpu() for x in tree_leaves(engine.W)]
    same = {k: getattr(hist, k) == ref[k]
            for k in ("losses", "sync_steps", "period_history", "s_k",
                      "n_syncs")}
    same["W"] = len(W) == len(ref["W"]) and all(
        torch.equal(a, b) for a, b in zip(W, ref["W"]))
    print(f"  {label} on the mesh: history and final W bitwise the vmap "
          f"run's: {same}")
    check(all(same.values()), f"{label}: the mesh run differs from vmap: "
                              f"{same}")
    by_program, by_group = {}, {}
    for name, calls, tagged, groups in log:
        by_program.setdefault(name, []).append(
            ([op for op, _ in calls], [n for _, n in calls], tagged))
        by_group.setdefault(name, set()).add(tuple(
            f"{op}@{g}" for (op, _), g in zip(calls, groups)))
    for name, rows in by_program.items():
        print(f"  {label} collectives per {name} call: "
              f"{sorted({(tuple(ops), tagged) for ops, _, tagged in rows})}"
              f"; by group: {sorted(by_group[name])}")
    steps = [(calls, tagged, groups) for name, calls, tagged, groups in log
             if name == "step"]
    n_local = engine.backend.n_local
    # the step: its metrics mean (data); under replica_tp each replica's
    # gradient norm summed over the model group besides
    want = ["all_reduce@data"] + (["all_reduce@model"] * n_local if tp
                                  else [])
    check(len(steps) == len(hist.losses) and all(
        tagged == 1 and sorted(f"{op}@{g}" for (op, _), g in
                               zip(calls, groups)) == sorted(want)
        and all(n <= 64 for _, n in calls)
        for calls, tagged, groups in steps),
        f"{label}: a local step issued a collective besides its metrics "
        f"mean and its model-group gradient norms")
    if tp:
        print(f"  {label} DTensor collectives in the first local step "
              f"(model mesh of {engine.backend.m}): {dtensor}")
    out.update(engine=engine, hist=hist, by_program=by_program,
               by_group={k: sorted(v) for k, v in by_group.items()},
               dtensor_step_collectives=dtensor[:1],
               describe=engine.backend.describe())
    return out


def check_mesh_launches(label: str, run: dict, engine, hist) -> None:
    """A mesh run's kernel launches and its syncs' collectives: the mean +
    sqdev kernel twice a sync (modes mean and sync_to; a DaSGD snapshot
    mean and delta_to), a quantized sync one all_gather of R_local ×
    ``payload_bytes`` and its kernels per leaf, every other sync two
    all-reduces; an inner sync inside the chunk none."""
    from repro_torch.backends.ops import quantized_all_mean_op

    calls, progs = run["calls"], run["by_program"]
    n = hist.n_syncs
    if label == "qsgd_periodic":
        n_params = engine.backend.n_params(engine.W)
        payload = quantized_all_mean_op(BITS).payload_bytes(
            n_params, N_LEAVES)
        syncs = progs["sync"]
        check(syncs[0][0] == ["all_reduce"] * 3 and all(
            ops == ["all_gather"]
            and nb == [engine.backend.n_local * payload]
            for ops, nb, _ in syncs[1:]),
            f"quantized syncs' collectives {syncs}")
        q = N_LEAVES * 4 * (n - 1)
        want = {"mean_and_sqdev": 2 + N_LEAVES * (n - 1),
                LEAVES: 2 * N_LEAVES + N_LEAVES * (n - 1),
                "sqnorm": N_LEAVES * (n - 1), "quantize": q,
                "dequantize": q, "flash_attention": 0}
        run["payload_bytes"] = engine.backend.n_local * payload
    else:
        syncs = progs.get("sync", []) + progs.get("full_sync", [])
        if label == "dasgd":
            check(all(ops == ["all_reduce"] for ops, _, _ in
                      progs["sync"] + progs["sync_apply"]),
                  "a DaSGD snapshot or apply issued other than one "
                  "all-reduce")
            k = 2 * calls.get("full_sync", 0) + calls["sync"] \
                + calls["sync_apply"]
        else:
            check(all(ops == ["all_reduce", "all_reduce"]
                      for ops, _, _ in syncs),
                  f"{label}: a sync issued other than 2 "
                  f"all-reduces")
            k = 2 * calls["sync"]
            check(all(ops == [] for ops, _, _ in
                      progs.get("inner_sync", [])),
                  "an inner sync inside the chunk issued a "
                  "collective")
        want = dict(dict.fromkeys(COUNTS, 0), mean_and_sqdev=k,
                    **{LEAVES: N_LEAVES * k})
    check(run["launches"] == want,
          f"{label}: launches {run['launches']} != {want}")


def start_mesh_cli(extra=(), nproc: int = 1, steps: int = 4,
                   out=None) -> dict:
    """Start the training CLI under ``torch.distributed.run --standalone
    --nproc-per-node nproc`` (on the card): phase 3's arguments on the
    mesh, ``steps`` steps, ``extra`` flags (the placement), the history
    to ``out``.  ``finish_mesh_cli`` collects and checks it."""
    import os
    argv = on_mesh(MAIN_ARGV, steps=steps) + list(extra)
    if out is not None:
        argv += ["--out", str(out)]
    cmd = ["-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
           *argv]
    job = start_job(cmd, dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    job.update(cmd=cmd, extra=list(extra))
    return job


def finish_mesh_cli(job: dict) -> dict:
    """Wait for ``start_mesh_cli``'s run: exit 0, the mesh's describe()
    over NCCL printed, and its placement."""
    rc, stdout, stderr, dt = finish_cpu_job(job)
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    print(f"  CLI under the launcher ({dt:.1f} s since its start, exit "
          f"{rc}): {' '.join(job['cmd'])}")
    for ln in lines:
        print(f"    {ln}")
    check(rc == 0, f"the CLI under torch.distributed.run failed:\n"
                   f"{stderr[-3000:]}")
    check(any("'backend': 'mesh'" in ln and "'process_group': 'nccl'" in ln
              for ln in lines), "the CLI did not print the mesh's describe()")
    extra = job["extra"]
    if "--placement" in extra:
        placement = extra[extra.index("--placement") + 1]
        check(any(f"'placement': '{placement}'" in ln for ln in lines),
              f"the CLI did not run placement {placement}")
    return {"seconds": dt, "exit": rc, "lines": lines}


def phase_mesh(refs: dict, cli: dict) -> dict:
    """The mesh backend over NCCL at world 1 on the card: one NCCL rank
    in this process (``launch/mesh.py::init_group``; the CLI's own group
    below); phase 3's ADPSGD, phase 3b's qsgd_periodic and phase 7's dasgd
    and hier_adpsgd with ``--backend mesh``, each history and final W
    bitwise the vmap run's (``refs``); the collective calls of every
    program (a local step: none but its metrics mean, one all-reduce of a
    few floats; a sync: two, the mean bucket and S_k; a quantized sync:
    one all_gather of R_local × ``payload_bytes(n_params, n_leaves)``;
    DaSGD's snapshot and apply: one each); the sync on an 8-leaf tree
    (the CNN's leaf shapes) to show the count does not follow the
    leaves; the sync's time beside the vmap sync's (host clock) and its
    kernel part by CUDA events; then the CLI under the launcher
    (``cli``, from ``start_mesh_cli``, started with phase 9)."""
    import torch
    import torch.distributed as dist
    from repro_torch.backends import make_backend
    from repro_torch.launch import mesh as mesh_mod

    t0 = time.perf_counter()
    mesh_mod.init_group(torch.device("cuda", 0))
    print(f"  NCCL group of 1 rank up in {time.perf_counter() - t0:.2f} s "
          f"(backend {dist.get_backend()}, torch.distributed "
          f"{torch.__version__})")
    out = {"launches": dict.fromkeys(COUNTS, 0)}
    try:
        for label, argv in (("adpsgd", MAIN_ARGV),
                            ("qsgd_periodic", QSGD_PERIODIC_ARGV),
                            ("dasgd", DASGD_ARGV),
                            ("hier_adpsgd", HIER_ARGV)):
            run = mesh_run(label, on_mesh(argv), refs[label])
            engine, hist = run.pop("engine"), run.pop("hist")
            check_mesh_launches(label, run, engine, hist)
            for key in COUNTS:
                out["launches"][key] += run["launches"][key]
            if label == "adpsgd":
                out["timing"] = mesh_sync_timing(engine, refs)
            out[label] = {k: run[k] for k in ("ms", "peak_bytes", "n_syncs",
                                              "launches", "describe")}
            out[label]["collectives"] = {
                name: sorted({(tuple(ops), tagged) for ops, _, tagged in rows})
                for name, rows in run["by_program"].items()}
            print(f"  {label} mesh: sync ms median "
                  f"{run['ms'].get('sync')!r} (vmap "
                  f"{refs[label]['ms'].get('sync')!r}); peak "
                  f"{run['peak_bytes']} B")
            del engine, hist, run
            release()
        small = make_backend("mesh")
        small.bind(4)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        tree = [torch.randn((4, *s), generator=gen, device="cuda")
                for s in CNN_LEAF_SHAPES]
        counter = Collectives()
        try:
            small.all_mean()(tree, None)
        finally:
            counter.close()
        ops = [op for op, _ in counter.calls]
        print(f"  sync of an {len(tree)}-leaf tree: collectives {ops} (OLMo's"
              f" {N_LEAVES} leaves: 2 all-reduces)")
        check(ops == ["all_reduce", "all_reduce"],
              f"the 8-leaf sync issued {ops}")
        out["small_tree_collectives"] = ops
        del tree, small
    finally:
        dist.destroy_process_group()
    release()
    out["cli"] = finish_mesh_cli(cli)
    return out


TP_FLAGS = ["--placement", "replica_tp", "--model-parallel"]


def phase_mesh_tp(refs: dict, ddp: dict, cli: dict) -> dict:
    """The mesh's ``replica_tp`` placement over NCCL at world 1 (one GPU:
    a model axis of 1, every replica's forward and backward on DTensors
    over a one-rank model mesh): phase 3's ADPSGD, phase 3b's
    qsgd_periodic and phase 7's dasgd with ``--placement replica_tp
    --model-parallel 1``, each history and final W bitwise the vmap run's
    (``refs``), the collective calls of every program by group (data /
    model / world) and the DTensor collectives of a local step, the local
    step's and the sync's ms beside ``replica_ddp``'s (phase 15, ``ddp``)
    and vmap's, the peak memory; then the CLI under the launcher with
    ``--placement replica_tp`` (``cli``, started with phase 9), and, on a
    host of two GPUs or more, the CLI on two ranks of one replica
    (``tp_multi_gpu``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod

    mesh_mod.init_group(torch.device("cuda", 0))
    out = {"launches": dict.fromkeys(COUNTS, 0)}
    try:
        for label, argv in (("adpsgd", MAIN_ARGV),
                            ("qsgd_periodic", QSGD_PERIODIC_ARGV),
                            ("dasgd", DASGD_ARGV)):
            run = mesh_run(label, on_mesh(argv) + TP_FLAGS + ["1"],
                           refs[label], tp=True)
            engine, hist = run.pop("engine"), run.pop("hist")
            check(run["describe"]["placement"] == "replica_tp"
                  and run["describe"]["model_parallel"] == 1,
                  f"{label}: not the replica_tp placement: "
                  f"{run['describe']}")
            check_mesh_launches(label, run, engine, hist)
            for key in COUNTS:
                out["launches"][key] += run["launches"][key]
            ms = {"tp": run["ms"], "ddp": ddp[label]["ms"],
                  "vmap": refs[label]["ms"]}
            whole = dict(engine.backend.whole)
            print(f"  {label} replica_tp: torch functions run on whole "
                  f"operands (DTensor cannot shard them), calls: {whole}")
            out[label] = {"ms": ms, "peak_bytes": run["peak_bytes"],
                          "whole": whole,
                          "ddp_peak_bytes": ddp[label]["peak_bytes"],
                          "n_syncs": run["n_syncs"],
                          "launches": run["launches"],
                          "by_group": run["by_group"],
                          "dtensor_step_collectives":
                              run["dtensor_step_collectives"]}
            print(f"  {label} replica_tp: local step ms median "
                  f"{ms['tp'].get('step')!r} (replica_ddp "
                  f"{ms['ddp'].get('step')!r}, vmap "
                  f"{ms['vmap'].get('step')!r}); sync ms median "
                  f"{ms['tp'].get('sync')!r} (replica_ddp "
                  f"{ms['ddp'].get('sync')!r}, vmap "
                  f"{ms['vmap'].get('sync')!r}); peak {run['peak_bytes']} B "
                  f"(replica_ddp {ddp[label]['peak_bytes']} B)")
            del engine, hist, run
            release()
    finally:
        dist.destroy_process_group()
    release()
    out["cli"] = finish_mesh_cli(cli)
    out["multi_gpu"] = tp_multi_gpu(refs["adpsgd"])
    return out


def tp_multi_gpu(ref: dict, steps: int = 16) -> dict:
    """The CLI on two GPUs as one replica (``--nproc-per-node 2
    --model-parallel 2``), and on four as two replicas of two GPUs where
    the host has them, each held to the vmap run ``ref`` (phase 3): the
    same sync schedule, losses rtol 5e-4, S_k rtol 2e-3 (the reference's
    family tolerances for ``replica_tp``); each rank's parameter bytes as
    the CLI prints them.  On one GPU it says why it did not run."""
    import tempfile
    import numpy as np
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"  multi-GPU replica_tp: not run: this host shows {n} GPU "
              f"(NCCL takes one rank a GPU; the model axis of 2 needs 2)")
        return {"ran": False, "gpus": n}
    out = {"ran": True, "gpus": n}
    for nproc in (2, 4) if n >= 4 else (2,):
        path = Path(tempfile.mkdtemp()) / "hist.json"
        res = finish_mesh_cli(start_mesh_cli(TP_FLAGS + ["2"], nproc=nproc,
                                             steps=steps, out=path))
        got = json.loads(path.read_text())
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"])]
        rel_s = [abs(a - b) / abs(b) for a, b in zip(got["s_k"], ref["s_k"])]
        run_s = [float(m.group(1)) for ln in res["lines"] for m in
                 [re.search(rf"{steps} steps in ([\d.]+)s", ln)] if m]
        row = {"seconds": res["seconds"], "run_s": run_s,
               "sync_steps": got["sync_steps"],
               "max_loss_rel": max(rel), "max_s_k_rel": max(rel_s),
               "bytes": [ln for ln in res["lines"] if "bytes by rank" in ln]}
        print(f"  multi-GPU replica_tp, {nproc} ranks, model axis 2: "
              f"{row}")
        check(got["sync_steps"] == ref["sync_steps"]
              and got["periods"] == ref["period_history"],
              f"{nproc} ranks: the sync schedule differs from vmap's")
        check(np.allclose(got["losses"], ref["losses"], rtol=5e-4,
                          atol=1e-5)
              and np.allclose(got["s_k"], ref["s_k"], rtol=2e-3, atol=1e-5),
              f"{nproc} ranks: losses or S_k beyond the tolerance: {row}")
        out[nproc] = row
    return out


def mesh_sync_timing(engine, refs) -> dict:
    """One mesh sync on the run's final W (noised first, since a run may
    end on a sync): the whole program (kernel, NCCL all-reduce of the
    bucket and of S_k) and its kernel part (modes mean + sync_to) by CUDA
    events, beside the vmap sync's kernel (mode sync)."""
    import torch
    from repro_torch.kernels import param_variance as pv
    from repro_torch.tree import tree_leaves

    engine.opt_state = None
    release()
    leaves = tree_leaves(engine.W)
    gen = torch.Generator(device=leaves[0].device)
    gen.manual_seed(7)
    with torch.no_grad():
        for x in leaves:
            x.add_(torch.randn(x.shape, generator=gen, device=x.device),
                   alpha=0.01)
    sync = engine.backend.all_mean()
    mean = pv.new_out(leaves, "mean")

    def kernel_part():
        pv.mean_and_sqdev_many(leaves, "mean", mean)
        pv.mean_and_sqdev_many(leaves, "sync_to", None, mean,
                               engine.backend.world)

    row = {"program_ms": cuda_ms(lambda: sync(engine.W, None), 10),
           "kernel_ms": cuda_ms(kernel_part, 10),
           "vmap_kernel_ms": cuda_ms(
               lambda: pv.mean_and_sqdev_many(leaves, "sync"), 10)}
    row["bound_ms"], row["bound_by"] = fused_sync_bound(
        [tuple(x.shape) for x in leaves])
    print(f"  timing mesh sync ({len(leaves)} leaves): program "
          f"{row['program_ms']!r} ms (kernels + NCCL at world 1), kernels "
          f"{row['kernel_ms']!r} ms (mean + sync_to), vmap kernel "
          f"{row['vmap_kernel_ms']!r} ms (sync); fused bound "
          f"{row['bound_ms']!r} ({row['bound_by']})")
    del mean
    return row


# ----------------------------------------------------------------- phase 10
def phase_dense_serving() -> dict:
    """MiniCPM-2B, GLM4-9B and Qwen2.5-14B at full width and depth, one
    after another (memory released between), through ``serve_checks``:
    a 1 x 2048 prefill (n_layers flash launches; within 1.25x the plain
    route's distance from f32) and generate 1 x (128 + 32)."""
    import dataclasses
    from repro_torch.configs import get_config

    out = {"launches": dict.fromkeys(COUNTS, 0)}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).model,
                                  max_seq_len=DENSE_SEQ)
        print(f"  {arch}: full width and depth (no cut)")
        res = serve_checks(cfg, DENSE_BATCH, DENSE_SEQ, DENSE_PROMPT,
                           DENSE_GEN)
        res["wall_s"] = time.perf_counter() - t0
        print(f"  {arch}: {res['wall_s']:.3f} s")
        for k in COUNTS:
            out["launches"][k] += res["launches"][k]
        out[arch] = res
    return out


# ----------------------------------------------------------------- phase 11
def phase_deepseek_training() -> dict:
    """ADPSGD on DeepSeek-V2-Lite at full width, 2 layers (layer 0's dense
    MLP of width 10944 and one MoE layer: 64 routed experts top 6 and 2
    shared, MLA), R = 4, adamw, batch 4 x 128, 16 steps, through the
    training CLI's setup (``DEEPSEEK_ARGV``).  Each sync's S_k against the
    plain version on the same pre-sync W, the last within rtol 1e-4;
    exactly one mean_and_sqdev launch per sync, covering the 27 leaves
    (the expert leaves (4, 64, 2048, 1408) and (4, 64, 1408, 2048), the
    router, MLA's projections, the embedding and the head), and no other
    kernel.  Prints the step and sync times, the peak bytes and the aux
    losses at the first and last step, then holds the grouped kernel
    against the plain version on the final W in its three modes and
    times one sync of this W four ways beside the fused bound
    (``phase_timing``)."""
    from repro_torch.launch.train import AuxLog

    probe = plain_sync_probe()
    out = drive(DEEPSEEK_ARGV, callbacks=[probe],
                n_leaves_want=DEEPSEEK_LEAVES)
    engine, hist = out.pop("engine"), out.pop("hist")
    check(out["n_params"] == DEEPSEEK_PARAMS,
          f"{out['n_params']} params per replica, not {DEEPSEEK_PARAMS}")
    out["s_k_rel"] = check_against_plain(hist, probe, out["launches"],
                                         DEEPSEEK_LEAVES)
    aux = next(cb for cb in engine.callbacks if isinstance(cb, AuxLog))
    steps = aux.history()
    print(f"  aux losses at step 0: {steps[0]}; at step "
          f"{len(steps) - 1}: {steps[-1]}")
    check(len(steps) == len(hist.losses) and all(
        math.isfinite(v) and v > 0 for a in steps for v in a.values()),
        "aux losses missing or not positive")
    out["aux"] = {"first": steps[0], "last": steps[-1]}
    out["grouped"] = grouped_on_final_W(engine, hist, "DeepSeek-V2-Lite W",
                                        32)
    out["timing"] = phase_timing(engine.W)
    del engine, hist
    release()
    return out


# ----------------------------------------------------------------- phase 12
def phase_moe_serving() -> dict:
    """DeepSeek-V2-Lite at full width and depth (27 layers, no cut) and
    Mixtral-8x22B at full width cut to 4 of its 56 layers (140.6 B
    parameters, 562.5 GB in f32, do not fit one card), one after another
    (memory released between), through ``serve_checks``: a 1 x 2048
    prefill and generate 1 x (128 + 32).  Neither reaches flash attention,
    in the reference as here (``flash_layers``): MLA attends through its
    own path and Mixtral's 4096 window bypasses flash, so both prefills
    expect 0 flash launches.  Checks the parameter counts and
    ``active_param_count``."""
    import dataclasses
    from repro_torch.configs import get_config

    out = {"launches": dict.fromkeys(COUNTS, 0)}
    for arch, (layers, n_params, n_active) in MOE_SERVE.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).model,
                                  max_seq_len=DENSE_SEQ)
        if layers:
            print(f"  {arch}: full width, cut to {layers} of "
                  f"{cfg.n_layers} layers")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        else:
            print(f"  {arch}: full width and depth (no cut)")
        res = serve_checks(cfg, DENSE_BATCH, DENSE_SEQ, DENSE_PROMPT,
                           DENSE_GEN)
        check(res["n_params"] == n_params and res["n_active"] == n_active,
              f"{arch}: {res['n_params']} params, {res['n_active']} active;"
              f" expected {n_params}, {n_active}")
        res["wall_s"] = time.perf_counter() - t0
        print(f"  {arch}: {res['wall_s']:.3f} s")
        for k in COUNTS:
            out["launches"][k] += res["launches"][k]
        out[arch] = res
    return out


# ----------------------------------------------------------------- phase 13
def add_frames(engine) -> None:
    """Whisper's loss reads ``frames``, which the training CLI's data does
    not carry (nor the reference's): every batch of ``engine`` gains
    frames (R, b, 1500, d_model), 0.1·N(0, 1) drawn on the card from a
    generator seeded with the step, as the reference's tests build them."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium").model
    tokens_fn = engine.data_fn
    gen = torch.Generator(device=DEVICE)

    def data_fn(step):
        batch = dict(tokens_fn(step))
        R, b = batch["tokens"].shape[:2]
        gen.manual_seed(step)
        batch["frames"] = 0.1 * torch.randn(
            (R, b, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device=DEVICE)
        return batch
    engine.data_fn = data_fn


def model_training(arch: str, argv, setup=None) -> dict:
    """ADPSGD through the training CLI's setup (``argv``: phase 13's at
    full width and depth, R = 4; phase 14's xLSTM whole at R = 4, Jamba
    cut to one layer at R = 2; ``setup`` may change the engine before the
    run).  Each sync's S_k against the plain version on the same pre-sync
    W, the last within rtol 1e-4; exactly one mean_and_sqdev launch per
    sync, covering every leaf, and no other kernel; the parameter count.
    Then the grouped kernel against the plain version on the final W in
    its three modes, and one sync of this W timed four ways beside the
    fused bound (``phase_timing``)."""
    n_leaves, n_params = {**VLM_AUDIO_TRAIN, **SSM_TRAIN}[arch]
    probe = plain_sync_probe()
    out = drive(argv, callbacks=[probe], setup=setup, n_leaves_want=n_leaves)
    engine, hist = out.pop("engine"), out.pop("hist")
    check(out["n_params"] == n_params,
          f"{out['n_params']} params per replica, not {n_params}")
    out["s_k_rel"] = check_against_plain(hist, probe, out["launches"],
                                         n_leaves)
    out["grouped"] = grouped_on_final_W(engine, hist, f"{arch} W", 33)
    out["timing"] = phase_timing(engine.W)
    del engine, hist
    release()
    return out


def vision_inputs(cfg, B: int):
    """Qwen2-VL's prefill inputs: a seeded vision prefix of n_patches
    embeddings, 0.02·N(0, 1), on a square grid, with M-RoPE positions (t
    = 0, h = row, w = column; the text after it t = h = w, counting on
    from the largest patch position).  Decode is text only, as the
    reference's."""
    import torch

    def inputs(params, gen):
        P, D = cfg.vision.n_patches, cfg.d_model
        side = math.isqrt(P)
        i = torch.arange(P, device=DEVICE)
        vis = torch.stack([torch.zeros_like(i), i // side, i % side])
        S = cfg.max_seq_len - P
        txt = (vis.max() + 1 + torch.arange(S, device=DEVICE)).expand(3, S)
        pos = torch.cat([vis, txt], dim=1).to(torch.int32)
        return {"prefill": {
                    "vision_embeds": 0.02 * torch.randn(
                        (B, P, D), generator=gen, device=DEVICE),
                    "mrope_pos": pos[:, None].expand(3, B, P + S)},
                "what": f" tokens + {P} patches ({side} x {side} grid, "
                        f"M-RoPE)"}
    return inputs


def audio_inputs(cfg, B: int):
    """Whisper's inputs: seeded frames, 0.1·N(0, 1), for the prefills,
    and for decode the encoder's output over them in f32, as the serving
    CLI computes it (from zero frames there)."""
    import torch
    from repro_torch.models import transformer as T

    def inputs(params, gen):
        frames = 0.1 * torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                                   generator=gen, device=DEVICE)
        with torch.inference_mode():
            enc = T.encoder_forward(params["encoder"], frames, cfg)
        return {"prefill": {"frames": frames}, "prompt": {"frames": frames},
                "decode": {"encoder_out": enc},
                "what": f" over {cfg.encoder.n_frames} frames"}
    return inputs


def phase_vlm_audio_serving() -> dict:
    """Qwen2-VL-2B and Whisper-medium at full width and depth (no cut),
    one after another (memory released between), through
    ``serve_checks``: Qwen2-VL prefills 1 x (64 patches + 1984 tokens)
    (28 flash launches at (1, 2048, 12, 2, 128)) and generates 1 x (128 +
    32) text only; Whisper prefills 4 x 512 over 1500 frames (24 flash
    launches at (4, 512, 16, 16, 64): its encoder and cross-attention
    reach none, as in the reference) and generates 4 x (128 + 32) reading
    the encoder's output.  Checks the parameter counts."""
    import dataclasses
    from repro_torch.configs import get_config

    out = {"launches": dict.fromkeys(COUNTS, 0)}
    for arch, (B, S, _, _, _) in VLM_AUDIO_ARCHS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).model, max_seq_len=S)
        print(f"  {arch}: full width and depth (no cut)")
        if cfg.vision is not None:
            text, inputs = S - cfg.vision.n_patches, vision_inputs(cfg, B)
        else:
            text, inputs = S, audio_inputs(cfg, B)
        res = serve_checks(cfg, B, text, VLM_AUDIO_PROMPT, VLM_AUDIO_GEN,
                           inputs=inputs)
        n_params = VLM_AUDIO_TRAIN[arch][1]
        check(res["n_params"] == n_params,
              f"{arch}: {res['n_params']} params, expected {n_params}")
        res["wall_s"] = time.perf_counter() - t0
        print(f"  {arch}: {res['wall_s']:.3f} s")
        for k in COUNTS:
            out["launches"][k] += res["launches"][k]
        out[arch] = res
    return out


# ----------------------------------------------------------------- phase 14
def phase_ssm_serving() -> dict:
    """xLSTM-350M at full width and depth (no cut: 21 mLSTM and 3 sLSTM
    layers, f32 parameters) and Jamba-1.5-Large at full width cut to
    layers 0-4 of 72 with bf16 parameters (``SSM_SERVE``), one after
    another (memory released between), through ``serve_checks``: a 1 x
    2048 prefill (xLSTM: 8 mLSTM chunks and 2048 sLSTM steps in each
    sLSTM layer, no flash launch; Jamba: one flash launch, at its
    attention layer (1, 2048, 64, 8, 128)) and generate 1 x (128 + 32),
    decoding against the recurrent states (and Jamba's one KV cache),
    each decode held to its prefill in bf16 and in f32.  Checks the
    parameter counts; Jamba's A_log and D stay f32 in bf16, as in the
    reference's init."""
    import dataclasses
    from repro_torch.configs import get_config

    out = {"launches": dict.fromkeys(COUNTS, 0)}
    for arch, (layers, dtype, n_params) in SSM_SERVE.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).model,
                                  max_seq_len=DENSE_SEQ, param_dtype=dtype)
        if layers:
            print(f"  {arch}: full width, cut to {layers} of "
                  f"{cfg.n_layers} layers, {dtype} parameters")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        else:
            print(f"  {arch}: full width and depth (no cut), {dtype} "
                  f"parameters")
        layer_ids = range(cfg.n_layers)
        print(f"  {arch}: layers {[cfg.block_kind(i) for i in layer_ids]}, "
              f"MoE on {[i for i in layer_ids if cfg.layer_uses_moe(i)]}")
        res = serve_checks(cfg, DENSE_BATCH, DENSE_SEQ, DENSE_PROMPT,
                           DENSE_GEN)
        check(res["n_params"] == n_params,
              f"{arch}: {res['n_params']} params, expected {n_params}")
        res["wall_s"] = time.perf_counter() - t0
        print(f"  {arch}: {res['wall_s']:.3f} s")
        for k in COUNTS:
            out["launches"][k] += res["launches"][k]
        out[arch] = res
    return out


# ------------------------------------------------------------------ phase 4
def phase_timing(W) -> dict:
    """mean_and_sqdev on the largest leaf (the one-leaf kernel, its plain
    version and ``torch.var_mean``) beside its bound, and one sync of all
    of W's leaves four ways beside the fused bound (``fused_sync_bound``;
    the kernel's bound in mode mean printed beside it): the grouped kernel
    (mode sync, the paths' route); the route before it (the one-leaf
    kernel per leaf, ``copy_`` of its mean into every replica, the Python
    sum of the sq); the library route (``torch.var_mean`` per leaf, then
    ``copy_`` of its mean: a yardstick the port never calls); the plain
    route (``mean_and_sqdev_many_ref``).  Each sync writes W in place."""
    import torch
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels.ref import (mean_and_sqdev_many_ref,
                                         mean_and_sqdev_ref)
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(W)
    R = leaves[0].shape[0]
    embed = max(leaves, key=lambda x: x.numel())
    row = {"ms": cuda_ms(lambda: pv.mean_and_sqdev(embed), 20),
           "plain_ms": cuda_ms(lambda: mean_and_sqdev_ref(embed), 20),
           "library_ms": cuda_ms(lambda: torch.var_mean(
               embed, dim=0, correction=0), 20)}
    row["bound_ms"], row["bound_by"] = mean_sqdev_bound([tuple(embed.shape)])
    out = {"embed": row}
    print(f"  timing mean_and_sqdev embed {tuple(embed.shape)}: "
          + " ".join(f"{k}={v}" for k, v in row.items()))

    def old_route():
        sks = []
        for x in leaves:
            mean, sk = pv.mean_and_sqdev(x)
            x.copy_(mean.unsqueeze(0).expand_as(x))
            sks.append(sk)
        return sum(sks) / R

    def library_route():
        for x in leaves:
            _, mean = torch.var_mean(x, dim=0, correction=0)
            x.copy_(mean.unsqueeze(0).expand_as(x))

    shapes = [tuple(x.shape) for x in leaves]
    row = {"ms": cuda_ms(lambda: pv.mean_and_sqdev_many(leaves, "sync"), 10),
           "old_ms": cuda_ms(old_route, 10),
           "library_ms": cuda_ms(library_route, 10),
           "plain_ms": cuda_ms(lambda: mean_and_sqdev_many_ref(leaves,
                                                               "sync"), 10)}
    row["bound_ms"], row["bound_by"] = fused_sync_bound(shapes)
    row["mean_bound_ms"] = mean_sqdev_bound(shapes)[0]
    row["n_leaves"] = len(leaves)
    out["sync"] = row
    print(f"  timing sync ({len(leaves)} leaves, R={R}): grouped "
          f"{row['ms']!r} ms, old route {row['old_ms']!r}, var_mean + copy_ "
          f"{row['library_ms']!r}, plain {row['plain_ms']!r}; fused bound "
          f"{row['bound_ms']!r} ({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%}"
          f" of it reached), the kernel's bound in mode mean "
          f"{row['mean_bound_ms']!r}")
    return out


def snapshot_timing(backend, W) -> dict:
    """DaSGD's snapshot (``mean_delta``) on W: the grouped kernel in mode
    delta (the path's route) and the route before it (the one-leaf kernel
    per leaf, then ``mean − w`` per leaf, the Python sum), beside the
    fused bound."""
    from repro_torch.kernels import param_variance as pv
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(W)
    R = leaves[0].shape[0]
    snapshot = backend.mean_delta()

    def old_route():
        deltas, sks = [], []
        for x in leaves:
            mean, sk = pv.mean_and_sqdev(x)
            deltas.append(mean.unsqueeze(0) - x)
            sks.append(sk)
        return deltas, sum(sks) / R

    row = {"ms": cuda_ms(lambda: snapshot(W), 10),
           "old_ms": cuda_ms(old_route, 10)}
    row["bound_ms"], row["bound_by"] = fused_sync_bound(
        [tuple(x.shape) for x in leaves])
    print(f"  timing dasgd snapshot ({len(leaves)} leaves): grouped "
          f"{row['ms']!r} ms, old route {row['old_ms']!r}; fused bound "
          f"{row['bound_ms']!r} ({row['bound_by']})")
    return row


def phase_qsgd_timing(W) -> dict:
    """sqnorm, quantize and dequantize: kernel, plain version and, where
    one PyTorch call computes the same function, that call (``torch.dot``
    of the flat view with itself; ``torch.mul(levels, norm / s)``; none
    for quantize), on one replica of the embedding leaf and over one whole
    exchange (29 leaves x 4 replicas); and the uniform generator's time
    per exchange, under the exchange's own keys.  sqnorm over an exchange
    is timed as the paths call it: grouped by leaf (qsgd_periodic, 29
    calls of 4, the kernels line's number) and by replica (qsgd, 4 calls of
    29), beside one call per tensor, ``torch.dot`` per tensor and
    ``torch._foreach_norm`` over the same groups (norms, not squares: a
    yardstick).  The uniforms are timed as ``prng.uniform`` draws them,
    in one piece, and in ``prng.CHUNK``-element pieces, alternately: one
    replica's embedding draw, an exchange's draws, and a whole quantize /
    dequantize round trip of the exchange (``qsgd.quantize_pytree`` per
    replica), with the embedding draw's peak bytes."""
    import torch
    from repro_torch.core import prng, qsgd
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
    by_leaf = [[x for x, *_ in items[i * R:(i + 1) * R]]
               for i in range(len(leaves))]
    by_replica = [[items[i * R + r][0] for i in range(len(leaves))]
                  for r in range(R)]
    grouped = {
        "by_leaf": lambda: [qq.sqnorm_many(g) for g in by_leaf],
        "by_replica": lambda: [qq.sqnorm_many(g) for g in by_replica],
    }
    for label, group, iters in (("embed", [embed], 20),
                                ("exchange", items, 5)):
        n_el = sum(it[0].numel() for it in group)
        for name, (kernel, plain, library) in fns.items():
            def over(fn, group=group):
                return lambda: [fn(*it) for it in group]
            kernel_ms = (cuda_ms(grouped["by_leaf"], iters)
                         if (name, label) == ("sqnorm", "exchange")
                         else cuda_ms(over(kernel), iters))
            row = {"ms": kernel_ms,
                   "plain_ms": cuda_ms(over(plain), iters),
                   "library_ms": (cuda_ms(over(library), iters)
                                  if library is not None else None)}
            row["bound_ms"], row["bound_by"] = qsgd_bound(name, n_el)
            out[(name, label)] = row
            print(f"  timing {name} {label} ({len(group)} tensors, "
                  f"{n_el} elements): "
                  + " ".join(f"{k}={v}" for k, v in row.items()))
    sq_ex = {
        "grouped_by_leaf_29x4": cuda_ms(grouped["by_leaf"], 5),
        "grouped_by_replica_4x29": cuda_ms(grouped["by_replica"], 5),
        "one_call_per_tensor_116": cuda_ms(
            lambda: [qq.sqnorm(x) for x, *_ in items], 5),
        "torch_dot_per_tensor_116": cuda_ms(
            lambda: [torch.dot(x.view(-1), x.view(-1)) for x, *_ in items],
            5),
        "foreach_norm_by_leaf_29x4": cuda_ms(
            lambda: [torch._foreach_norm(g) for g in by_leaf], 5),
        "foreach_norm_by_replica_4x29": cuda_ms(
            lambda: [torch._foreach_norm(g) for g in by_replica], 5),
    }
    print("  timing sqnorm per exchange (ms): " + json.dumps(sq_ex))
    print(f"  sqnorm grouped as the paths call it vs torch.dot per tensor: "
          f"{sq_ex['grouped_by_leaf_29x4']:.4f} / "
          f"{sq_ex['grouped_by_replica_4x29']:.4f} vs "
          f"{sq_ex['torch_dot_per_tensor_116']:.4f} ms")
    out["sqnorm_exchange"] = sq_ex
    del items, embed, by_leaf, by_replica
    release()
    rkeys = prng.replica_keys(prng.prng_key(17), range(R))
    keys = [prng.split(k, len(leaves)) for k in rkeys]
    e = max(range(len(leaves)), key=lambda i: leaves[i][0].numel())
    whole_uniform = prng.uniform

    def chunked_uniform(key, shape, device=None):
        """The rejected alternative: the draw in CHUNK-element pieces, as
        ``prng.normal`` makes it."""
        return prng._draw(key, shape, device, lambda u: u)

    draws = {
        "embed_uniform": (lambda: prng.uniform(
            keys[0][e], leaves[e].shape[1:], device=leaves[e].device), 5),
        "exchange_uniforms": (lambda: [
            prng.uniform(keys[r][i], w.shape[1:], device=w.device)
            for i, w in enumerate(leaves) for r in range(R)], 2),
        "exchange_round_trip": (lambda: [
            qsgd.quantize_pytree([w[r] for w in leaves], rkeys[r], BITS)
            for r in range(R)], 2),
    }
    rows = {name: {"whole": [], "chunked": []} for name in draws}
    transient = {}
    for label in ("chunked", "whole", "whole", "chunked"):
        prng.uniform = (chunked_uniform if label == "chunked"
                        else whole_uniform)
        try:
            for name, (fn, iters) in draws.items():
                rows[name][label].append(cuda_ms(fn, iters))
            release()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            draws["embed_uniform"][0]()
            transient[label] = torch.cuda.max_memory_allocated() - base
        finally:
            prng.uniform = whole_uniform
    print(f"  timing threefry uniforms in one piece (prng.uniform) against "
          f"CHUNK={prng.CHUNK}-element pieces, in the order chunked, whole, "
          f"whole, chunked (ms per call): " + json.dumps(rows))
    print(f"  embedding draw's peak bytes above the state: {transient}")
    out["uniform_ms"] = sum(rows["exchange_uniforms"]["whole"]) / 2
    out["chunking"] = dict(rows, embed_transient_bytes=transient)
    print(f"  timing uniform generator per exchange "
          f"({len(leaves)} leaves x {R} replicas): {out['uniform_ms']} ms")
    return out


def phase_flash_timing() -> dict:
    """flash attention at the OLMo-1B prefill layer and at each of the
    prefill layers of phases 10, 13 and 14, bf16, causal: the kernel, its
    plain version and torch's scaled_dot_product_attention
    (is_causal=True, enable_gqa where K < H; a yardstick the port never
    calls) by CUDA events; and
    at one prefill_32k layer the kernel and SDPA alone (the plain version's
    f32 logits would take 68 GB).  Prints the kernel's achieved TFLOP/s
    (the FLOPs its bound counts, over its time) and its share of the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    out = {}
    layers = [("olmo_prefill", OLMO_PREFILL, 20)]
    layers += [(f"{arch}_prefill", shape, 20)
               for arch, shape in {**DENSE_ARCHS, **VLM_AUDIO_ARCHS,
                                   "jamba-1.5-large-398b": JAMBA_PREFILL}
               .items()]
    for label, shape, iters in layers + [("prefill_32k", PREFILL_32K, 3)]:
        q, k, v = qkv(shape, torch.bfloat16, gen, DEVICE)
        B, S, H, K, d = shape
        # SDPA takes (B, H, S, d) and GQA through enable_gqa
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"ms": cuda_ms(lambda: fa.flash_attention(q, k, v), iters),
               "plain_ms": (cuda_ms(lambda: attention_ref(q, k, v), 3)
                            if label != "prefill_32k" else None),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=K != H), iters)}
        row["bound_ms"], row["bound_by"] = flash_bound(shape)
        flops = 4 * d * B * H * attention_pairs(S, S, True, 0)
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out[label] = row
        print(f"  timing flash_attention {label} {shape} bf16 causal: "
              + " ".join(f"{k}={v}" for k, v in row.items()))
        del q, k, v, qt, kt, vt
        release()
    return out


# ------------------------------------------------------------------ phase 5
# ----------------------------------------------------------------- phase 16
DRYRUN_ARCHS = ("olmo-1b", "mixtral-8x22b")   # the fake-mesh pairs, train_4k
PEAK_TOL = 0.15             # predicted peak against max_memory_allocated


def meta_like(tree):
    """Each tensor of ``tree`` as an empty tensor of its shape and dtype on
    the meta device."""
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def timed_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``reps`` synchronised calls."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dryrun_training() -> dict:
    """(a) Phase 3's configuration through ``make_steps``: the local and
    sync steps counted on meta tensors (``launch/dryrun.py::analyze``)
    against one real local step (``FlopCounterMode``, the peak of
    ``max_memory_allocated``) and one real sync (the launch counts) on
    the engine's W and optimizer state."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs, steps, train

    args = train.parse_args(MAIN_ARGV)
    release()
    engine, cfg = train.build_engine(args)
    fns = steps.make_steps(get_config(args.arch).replace(model=cfg))
    W, opt = engine.W, engine.opt_state
    batch = engine.backend.local_replicas(engine.data_fn(0))
    lr = args.lr
    meta_W = specs.abstract_params(cfg, n_replicas=args.replicas)
    meta_opt = specs.abstract_opt_state(fns["optimizer"], meta_W, True)
    _, loc = dryrun.analyze(fns["local_step"],
                            (meta_W, meta_opt, meta_like(batch), lr))
    _, syn = dryrun.analyze(fns["sync_step"], (meta_W, meta_opt))
    state = dryrun.tree_bytes((W, opt))
    arg_want = state + dryrun.tree_bytes(batch)
    print(f"  (a) meta local_step: {loc['aten_flops_per_chip']:.6e} FLOPs, "
          f"{loc['hbm_bytes_per_chip']:.6e} B, argument bytes "
          f"{loc['memory']['argument_bytes']} (engine W + optimizer state "
          f"{state} + batch = {arg_want}), predicted peak "
          f"{loc['memory']['peak_bytes']} B; meta sync_step kernels "
          f"{syn['kernels']}, argument bytes {syn['memory']['argument_bytes']}"
          f"; built in {loc['build_s']:.2f} / {syn['build_s']:.2f} s")
    check(loc["memory"]["argument_bytes"] == arg_want,
          f"local step argument bytes {loc['memory']['argument_bytes']} != "
          f"{arg_want}")
    check(syn["memory"]["argument_bytes"] == state,
          f"sync argument bytes {syn['memory']['argument_bytes']} != {state}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        fns["local_step"](W, opt, batch, lr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = fc.get_total_flops()
    pred = loc["memory"]["peak_bytes"]
    print(f"  (a) card local_step: FlopCounterMode {flops:.6e} FLOPs (meta "
          f"{loc['aten_flops_per_chip']:.6e}); max_memory_allocated {peak} B "
          f"({before} B allocated before it), predicted {pred} B: "
          f"{(pred - peak) / peak:+.4%}; the step's own rise {peak - before}"
          f" B, predicted temporaries {loc['memory']['temp_bytes']} B")
    check(flops == loc["aten_flops_per_chip"],
          f"meta FLOPs {loc['aten_flops_per_chip']} != card {flops}")
    check(abs(pred - peak) <= PEAK_TOL * peak,
          f"predicted peak {pred} not within {PEAK_TOL:.0%} of {peak}")
    step_ms = timed_ms(lambda: fns["local_step"](W, opt, batch, lr))
    reset_counts()
    fns["sync_step"](W, opt)
    torch.cuda.synchronize()
    launches = read_counts()
    recorded = {k: v["calls"] for k, v in syn["kernels"].items()}
    print(f"  (a) card sync_step launches {launches}; recorded on meta "
          f"{recorded}")
    for name in KERNEL_NAMES:
        check(launches[name] == recorded.get(name, 0),
              f"{name}: {launches[name]} launches, {recorded.get(name, 0)} "
              f"recorded")
    check(recorded.get("mean_and_sqdev") == 1, "the sync is one launch")
    sync_ms = timed_ms(lambda: fns["sync_step"](W, opt))
    del engine, W, opt, batch
    release()
    return {"local": loc, "sync": syn, "step_ms": step_ms,
            "sync_ms": sync_ms, "peak_bytes": peak, "flops": flops,
            "launches": launches}


def dryrun_prefill() -> dict:
    """(b) Phase 5's prefill (OLMo-1B, all 16 layers, 4 x 2048, flash)
    counted on meta against one real prefill: flash calls recorded equal
    to launches, each call's cost the kernel's."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.cost import flash_cost
    from repro_torch.launch import dryrun, specs, steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(serve_config(), use_flash=True)
    step = steps.make_prefill_step(cfg)

    def prefill(params, batch):
        with torch.inference_mode():
            return step(params, batch)
    release()
    params = M.init_params(0, cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (SERVE_BATCH, SERVE_SEQ), generator=gen,
                                     device=DEVICE, dtype=torch.int32)}
    _, pre = dryrun.analyze(prefill, (specs.abstract_params(cfg),
                                      meta_like(batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with FlopCounterMode(display=False) as fc:
        prefill(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    flash = pre["kernels"].get("flash_attention", {})
    d = cfg.head_dim()
    one = flash_cost(SERVE_BATCH, SERVE_SEQ, SERVE_SEQ, cfg.n_heads,
                     cfg.n_kv_heads, d, True, 0, 2)
    print(f"  (b) meta prefill {SERVE_BATCH}x{SERVE_SEQ}: flash recorded "
          f"{flash}; card launches {launches}; aten FLOPs meta "
          f"{pre['aten_flops_per_chip']:.6e} card {fc.get_total_flops():.6e}"
          f"; peak predicted {pre['memory']['peak_bytes']} B, "
          f"max_memory_allocated {peak} B")
    check(flash.get("calls") == launches["flash_attention"] == cfg.n_layers,
          f"flash recorded {flash.get('calls')}, launched "
          f"{launches['flash_attention']}, layers {cfg.n_layers}")
    check(flash["bytes"] == cfg.n_layers * one[0]
          and flash["ops"] == cfg.n_layers * one[1],
          "the recorded flash costs are not the kernel's")
    prefill_ms = timed_ms(lambda: prefill(params, batch))
    del params
    release()
    return {"prefill": pre, "prefill_ms": prefill_ms, "launches": launches,
            "peak_bytes": peak}


def start_dryruns() -> dict:
    """(d) ``python -m repro_torch.launch.dryrun`` on the fake 32 x 8 mesh
    for each of ``DRYRUN_ARCHS`` x train_4k, one helper process each
    (this process holds phase 15's NCCL group), started with the script:
    the dry run needs no card, and its minutes of host work run beside
    the card's phases."""
    return {arch: start_cpu_job(["-m", "repro_torch.launch.dryrun",
                                 "--arch", arch, "--shape", "train_4k"])
            for arch in DRYRUN_ARCHS}


def dryrun_subprocess(card: str, jobs: dict) -> dict:
    """(d) The dry runs ``start_dryruns`` started: each exits 0; each
    program's three roofline terms and its predicted memory a GPU,
    beside the card's memory."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for arch in DRYRUN_ARCHS:
        rc, stdout, stderr, wall = finish_cpu_job(jobs[arch])
        own = [ln for ln in stdout.splitlines() if " pairs in " in ln]
        print(f"  (d) dryrun {arch} train_4k: exit {rc}, collected {wall:.1f}"
              f" s after its start ({own[-1] if own else 'no summary'})")
        check(rc == 0, f"the dry run of {arch} failed:\n"
              + stdout[-3000:] + stderr[-3000:])
        rec = json.loads((ROOT / "experiments" / "dryrun_torch"
                          / f"{arch}__train_4k__32x8.json").read_text())
        for prog, r in rec["programs"].items():
            t = r["roofline"]
            peak = r["memory"]["peak_bytes"]
            print(f"  (d) {arch} {prog}: compute {t['compute_s']:.4e} s, "
                  f"memory {t['memory_s']:.4e} s (the least traffic "
                  f"{r['roofline_io']['memory_s']:.4e} s), collective "
                  f"{t['collective_s']:.4e} s ({t['dominant']}); "
                  f"{peak} B a GPU ({peak / 2**30:.2f} GiB): "
                  f"{'fits' if peak <= total else 'does not fit'} the "
                  f"card's {total} B ({card})")
        out[arch] = {"wall_s": wall, "programs": {
            p: {"roofline": r["roofline"], "roofline_io": r["roofline_io"],
                "peak_bytes":
                r["memory"]["peak_bytes"], "fits": r["memory"]["peak_bytes"]
                <= total} for p, r in rec["programs"].items()}}
    return out


def phase_dryrun(card: str, jobs: dict) -> dict:
    """Phase 16: the dry run's counts against the card: (a) phase 3's
    training steps, (b) phase 5's prefill, (c) the roofline share of the
    measured step and prefill, (d) the fake-mesh dry run (``jobs``, from
    ``start_dryruns``)."""
    train_ = dryrun_training()
    prefill = dryrun_prefill()
    recs = {"local_step": (train_["local"], train_["step_ms"]),
            "sync_step": (train_["sync"], train_["sync_ms"]),
            "prefill_step": (prefill["prefill"], prefill["prefill_ms"])}
    share = {}
    for key, what in (("roofline_io", "the least traffic: each argument "
                       "read once, each result written once"),
                      ("roofline", "the eager ops' own traffic")):
        share[key] = {p: r[key]["bound_s"] * 1e3 / ms
                      for p, (r, ms) in recs.items()}
        print(f"  (c) roofline share (bound_s / measured) against {what} ("
              f"{key}): " + "; ".join(
                  f"{p} {share[key][p]:.4f} ({ms:.3f} ms measured, bound "
                  f"{r[key]['bound_s'] * 1e3:.3f} ms, {r[key]['dominant']})"
                  for p, (r, ms) in recs.items()) + f"  card: {card}")
    sub = dryrun_subprocess(card, jobs)
    launches = dict.fromkeys(COUNTS, 0)
    for part in (train_["launches"], prefill["launches"]):
        for k in COUNTS:
            launches[k] += part[k]
    return {"share": share, "step_ms": train_["step_ms"],
            "sync_ms": train_["sync_ms"],
            "prefill_ms": prefill["prefill_ms"],
            "peak_bytes": {"local_step": train_["peak_bytes"],
                           "prefill": prefill["peak_bytes"]},
            "predicted_peak_bytes": {
                "local_step": train_["local"]["memory"]["peak_bytes"],
                "prefill": prefill["prefill"]["memory"]["peak_bytes"]},
            "dryrun": sub, "launches": launches}


def remat_meta_peaks(layers: int = 16) -> dict:
    """Phase 17's local step (``launch/steps.py::make_steps``; OLMo-1B at
    full width and ``layers`` layers, R x batch x seq of ``REMAT_ARGV``)
    counted on meta tensors (``launch/dryrun.py::analyze``) with remat
    off and "nothing": each one's peak bytes and FLOPs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs, steps
    run = get_config("olmo-1b")
    out = {}
    for policy in ("off", "nothing"):
        cfg = dataclasses.replace(run.model, max_seq_len=REMAT_SEQ,
                                  n_layers=layers, remat=policy != "off")
        fns = steps.make_steps(run.replace(model=cfg))
        W = specs.abstract_params(cfg, n_replicas=REMAT_R)
        opt = specs.abstract_opt_state(fns["optimizer"], W, True)
        batch = {"tokens": torch.empty((REMAT_R, REMAT_BATCH, REMAT_SEQ),
                                       dtype=torch.int32, device="meta")}
        _, rec = dryrun.analyze(fns["local_step"], (W, opt, batch, 4e-4))
        out[policy] = {"peak_bytes": rec["memory"]["peak_bytes"],
                       "flops": rec["aten_flops_per_chip"],
                       "build_s": rec["build_s"]}
    return out


def main_remat_peaks() -> int:
    """``--remat-peaks``: ``remat_meta_peaks()`` as JSON (``start_cpu_job``
    runs it beside the card's phases)."""
    print(json.dumps(remat_meta_peaks()))
    return 0


def remat_policies() -> dict:
    """(b) One replica's loss and gradients (``core/averaging.py::
    value_and_grad``, as the local step takes them) of OLMo-1B at full
    width and ``REMAT_B_LAYERS`` layers on one batch of REMAT_BATCH x 4096
    tokens, the same parameters, under remat off, "nothing" and "dots":
    the losses and every gradient leaf bitwise equal, the peaks above the
    memory allocated before ordered nothing < dots < off."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import averaging as avg
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    base = dataclasses.replace(get_config("olmo-1b").model,
                               max_seq_len=REMAT_SEQ,
                               n_layers=REMAT_B_LAYERS)
    params = M.init_params(0, base, device=DEVICE)
    batch = SyntheticTokens(base.vocab_size, REMAT_SEQ,
                            n_samples=REMAT_BATCH * 64, seed=0).batches(
        n_replicas=1, per_replica_batch=REMAT_BATCH, device=DEVICE)(0)
    batch = {k: v[0] for k, v in batch.items()}

    def cfg_of(policy):
        if policy == "off":
            return dataclasses.replace(base, remat=False)
        return dataclasses.replace(base, remat=True, remat_policy=policy)

    avg.value_and_grad(make_loss_fn(cfg_of("off")), params, batch)  # warm
    got = {}
    for policy in REMAT_POLICIES:
        loss_fn = make_loss_fn(cfg_of(policy))
        release()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _, grads = avg.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        got[policy] = (loss, tree_leaves(grads), peak, ms)
        print(f"  (b) remat {policy}: loss {float(loss)!r}, peak above the "
              f"{before} B before it {peak} B ({peak / 2**30:.2f} GiB), "
              f"{ms:.3f} ms")
    loss0, grads0 = got["off"][:2]
    equal = {}
    for policy in ("nothing", "dots"):
        loss, grads = got[policy][:2]
        equal[policy] = bool(torch.equal(loss, loss0)) and all(
            torch.equal(a, b) for a, b in zip(grads, grads0))
    print(f"  (b) loss and all {len(grads0)} gradient leaves bitwise the "
          f"remat-off ones: {equal}")
    check(all(equal.values()), f"remat changed the gradients: {equal}")
    peaks = {p: got[p][2] for p in REMAT_POLICIES}
    check(peaks["nothing"] < peaks["dots"] < peaks["off"],
          f"peaks not ordered nothing < dots < off: {peaks}")
    out = {"peak_bytes": peaks, "ms": {p: got[p][3] for p in REMAT_POLICIES},
           "bitwise": equal}
    del params, batch, got, grads0, loss0
    release()
    return out


def phase_remat(card: str, job: dict) -> dict:
    """Phase 17: (a) OLMo-1B at full width and all 16 layers trained at
    4096 tokens (``REMAT_ARGV``) under the config's remat: each sync's S_k
    against the plain version, one mean_and_sqdev launch a sync; the
    card's peak under 80 GiB and within 5 % of the meta count with remat
    on, which remat off's (``job``, ``--remat-peaks``) exceeds; (b)
    ``remat_policies``."""
    import torch
    from repro_torch.configs import get_config
    rc, stdout, stderr, wall = finish_cpu_job(job)
    check(rc == 0, "the meta count of phase 17 failed:\n" + stdout[-2000:]
          + stderr[-2000:])
    meta = json.loads(stdout.strip().splitlines()[-1])
    off, on = meta["off"]["peak_bytes"], meta["nothing"]["peak_bytes"]
    cfg = get_config("olmo-1b").model
    print(f"  (a) the config's remat={cfg.remat} policy={cfg.remat_policy!r}"
          f"; meta local step peak: remat off {off} B ({off / 2**30:.2f} "
          f"GiB), remat nothing {on} B ({on / 2**30:.2f} GiB); FLOPs off "
          f"{meta['off']['flops']:.6e}, nothing "
          f"{meta['nothing']['flops']:.6e} (collected {wall:.1f} s after "
          f"its start)")
    check(cfg.remat and cfg.remat_policy == "nothing",
          "OLMo-1B's config does not ask for remat nothing")
    check(off > REMAT_CARD_GIB * 2**30,
          f"remat off's meta peak {off} B does not pass {REMAT_CARD_GIB} GiB")
    check(on <= (REMAT_CARD_GIB - REMAT_FREE_GIB) * 2**30,
          f"remat nothing's meta peak {on} B leaves less than "
          f"{REMAT_FREE_GIB} GiB free")
    n_leaves, n_params = REMAT_TRAIN
    probe = plain_sync_probe()
    out = drive(REMAT_ARGV, callbacks=[probe], n_leaves_want=n_leaves)
    engine, hist = out.pop("engine"), out.pop("hist")
    check(out["n_params"] == n_params,
          f"{out['n_params']} params per replica, not {n_params}")
    out["s_k_rel"] = check_against_plain(hist, probe, out["launches"],
                                         n_leaves)
    peak = out["peak_bytes"]
    rel = (on - peak) / peak
    print(f"  (a) card: max_memory_allocated {peak} B ({peak / 2**30:.2f} "
          f"GiB), meta with remat {on} B: {rel:+.4%}; step ms "
          f"{out['ms'].get('step')!r}, sync ms {out['ms'].get('sync')!r}  "
          f"card: {card}")
    check(peak < REMAT_CARD_GIB * 2**30,
          f"the card's peak {peak} B is not under {REMAT_CARD_GIB} GiB")
    check(abs(rel) <= REMAT_PEAK_TOL,
          f"meta peak {on} not within {REMAT_PEAK_TOL:.0%} of {peak}")
    del engine, hist
    release()
    out["meta"] = meta
    out["policies"] = remat_policies()
    return out


def serve_config():
    """OLMo-1B as published: all 16 layers, d_model 2048, vocab 50304."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmo-1b").model,
                               max_seq_len=SERVE_SEQ)


def phase_serving() -> dict:
    """OLMo-1B at its published width and all 16 layers: 4 x 2048
    prefill, generate 4 x (128 + 128)."""
    return serve_checks(serve_config(), SERVE_BATCH, SERVE_SEQ, SERVE_PROMPT,
                        SERVE_GEN)


def flash_layers(cfg) -> int:
    """The layers whose prefill reaches flash attention when use_flash is
    set: GQA attention layers without a sliding window, the reference's
    rule (``repro/models/layers.py:235``); MLA never does, nor a Mamba,
    mLSTM or sLSTM layer."""
    if cfg.attention_type == "mla" or cfg.sliding_window:
        return 0
    return sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


class replay_routing:
    """Within ``with``, wraps ``moe_route``.  Each call's top-k experts
    (T, k) are kept, and ``take()`` returns and clears them; after
    ``replay(decode_calls, P)``, the prefill of the same B x P tokens that
    follows (one call per MoE layer) routes each token to the experts its
    decode step chose (P steps, one call per MoE layer each), each
    weighted by the prefill's own router probability there, renormalised
    as ``moe_route`` does; ``taken()`` then gives, per MoE layer, the
    tokens whose own top-k differ from those, and the (token, expert)
    slots dropped at capacity."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self._layers, self._route = L, L.moe_route
        self._calls, self._replay, self._taken = [], [], []

        def route(p, x, cfg, group_size=256):
            import torch
            import torch.nn.functional as F
            r = self._route(p, x, cfg, group_size)
            k = cfg.moe.top_k
            if not self._replay:
                self._calls.append(r["gate_idx"].reshape(-1, k))
                return r
            idx = self._replay.pop(0).reshape(r["gate_idx"].shape)
            vals = torch.gather(r["probs"], -1, idx)
            differ = (idx.sort(-1).values
                      != r["gate_idx"].sort(-1).values).any(-1)
            onehot = F.one_hot(idx, cfg.moe.n_experts)
            flat = onehot.reshape(r["G"], -1, cfg.moe.n_experts)
            place = ((torch.cumsum(flat, dim=1) * flat).sum(-1) - 1
                     ).reshape(idx.shape)
            keep = place < r["C"]
            self._taken.append((int(differ.sum()), int((~keep).sum())))
            return dict(r, gate_idx=idx, onehot=onehot, place=place,
                        keep=keep, gate_vals=vals / torch.clamp(
                            vals.sum(-1, keepdim=True), min=1e-9))
        L.moe_route = route
        return self

    def take(self) -> list:
        calls, self._calls = self._calls, []
        return calls

    def replay(self, decode_calls: list, P: int) -> None:
        import torch
        n = len(decode_calls) // P
        check(n * P == len(decode_calls), "decode routed unevenly")
        # per MoE layer, the (P, B, k) steps in the prefill's batch-major
        # token order
        self._replay = [torch.stack(decode_calls[li::n]).transpose(0, 1)
                        for li in range(n)]

    def taken(self) -> tuple:
        check(not self._replay, "a replayed routing was not taken")
        taken, self._taken = self._taken, []
        return [t[0] for t in taken], sum(t[1] for t in taken)

    def __exit__(self, *exc):
        self._layers.moe_route = self._route


def serve_checks(cfg, B: int, S: int, P: int, G: int, inputs=None) -> dict:
    """One model at the depth ``cfg`` gives, parameters from
    init_params(0) on the card (timed), through the server's entry points.
    ``inputs(params, gen)``, where given, returns the batch entries beside
    the tokens: ``prefill`` for (a) (a vision prefix with its M-RoPE
    positions, or frames), ``prompt`` for (c)'s prefill of the prompt,
    ``decode`` for every decode step of (b) and (c) (``generate``'s
    ``extra_batch``: the encoder's output), and ``what``, a description.

    (a) make_prefill_step on B x S tokens three ways: use_flash (one
        flash launch per layer that reaches it, ``flash_layers``, and no
        other kernel), the plain route (0 launches) and the plain route
        in f32 compute, the yardstick.  The flash route's max |d| of
        last-position logits from the yardstick must be at most 1.25x the
        plain bf16 route's (they differ only in how the attention's f32
        result is reached before its bf16 rounding; where no layer
        reaches flash the two routes are the same computation).
    (b) generate, B x (P prompt + G generated) tokens, f32 caches,
        use_flash set: every token in the vocabulary, 0 flash launches
        (decode is S = 1 against the cache).
    (c) decode_step's logits at the last prompt token against the plain
        prefill of the prompt, in bf16 and in f32.  A prefill routes a
        group of tokens and may drop some at capacity, decode routes one
        token and never drops, so a MoE config makes this comparison at
        a capacity factor of n_experts, every expert's capacity the whole
        group, and the prefills must drop nothing (the reference's own
        test raises it to 8.0 for the same reason,
        ``tests/test_models.py``; at 64 experts, top 6, that still drops
        slots).  Top-k routing is discontinuous, so each prefill
        here routes every token to the experts its decode step chose
        (``replay_routing``), weighted by its own router probabilities.
        bf16: max |d| at most twice the bf16 prefill's own distance from
        the f32 prefill at that routing (decode runs in f32 after layer
        0, since the caches are f32, so it lies about as far from the
        bf16 prefill as the f32 prefill does).  f32: every logit within
        5e-4 + 1e-3·|prefill| (the reference's test bounds), and the f32
        prefill's own routing the same as the f32 decode's for every
        token.  The timed prefills of (a) run the config's own capacity
        factor."""
    import dataclasses
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    release()
    torch.cuda.reset_peak_memory_stats()
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved()
    n_params = M.param_count(params)
    n_active = M.active_param_count(cfg, params)
    n_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    print(f"  model {cfg.name}: d_model={cfg.d_model} n_layers={cfg.n_layers}"
          f" heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.head_dim()} "
          f"vocab={cfg.vocab_size} tied={cfg.tie_embeddings} "
          f"params={n_params} active={n_active} ({n_bytes} B, "
          f"{n_bytes / 2**30:.2f} GiB {cfg.param_dtype}); init_params(0) on "
          f"the card {init_s:.3f} s, {reserved} B reserved after it")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    extra = inputs(params, gen) if inputs is not None else {}
    batch = {"tokens": tokens, **extra.get("prefill", {})}

    def prefill(c, b, reps=3):
        """(last logits, launches of the first call, median ms of reps)."""
        step = make_prefill_step(c)
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_counts()
            last = step(params, b)
            torch.cuda.synchronize()
            launches = read_counts()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                step(params, b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return (last.float(), launches,
                statistics.median(times) if times else None)

    flash, l_flash, ms_flash = prefill(flash_cfg, batch)
    plain, l_plain, ms_plain = prefill(cfg, batch)
    ref, _, ms_f32 = prefill(f32_cfg, batch, reps=1)
    d_flash = float((flash - ref).abs().max())
    d_plain = float((plain - ref).abs().max())
    top = [t.argmax(-1) for t in (flash, plain, ref)]
    agree = {"flash_plain": int((top[0] == top[1]).sum()),
             "flash_f32": int((top[0] == top[2]).sum()),
             "plain_f32": int((top[1] == top[2]).sum())}
    none = dict.fromkeys(COUNTS, 0)
    print(f"  (a) prefill {B}x{S}{extra.get('what', '')}: flash "
          f"{ms_flash:.3f} ms "
          f"launches={l_flash}; plain {ms_plain:.3f} ms launches={l_plain}; "
          f"f32 {ms_f32:.3f} ms")
    print(f"  (a) max |last logits - f32|: flash={d_flash!r} "
          f"plain={d_plain!r} ratio={d_flash / d_plain!r} (limit 1.25); "
          f"max |f32 logits|={float(ref.abs().max())!r}; greedy next token "
          f"agrees of {B}: {agree}")
    check(flash.shape == (B, cfg.vocab_size), "prefill shape")
    check(all(bool(torch.isfinite(t).all()) for t in (flash, plain, ref)),
          "non-finite prefill logits")
    check(l_flash == dict(none, flash_attention=flash_layers(cfg)),
          f"flash prefill launches {l_flash}")
    check(l_plain == none, f"plain prefill launches {l_plain}")
    check(d_flash <= 1.25 * d_plain,
          f"flash route {d_flash} from f32 > 1.25 x plain {d_plain}")
    del flash, plain, ref
    release()

    prompt = tokens[:, :P].contiguous()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    decode_extra = extra.get("decode", {})
    out = serve.generate(flash_cfg, params, prompt, G,
                         extra_batch=decode_extra)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    l_gen = read_counts()
    steps = P + G - 1
    new = out[:, P:]
    print(f"  (b) generate {B}x({P}+{G}): "
          f"{gen_s:.3f} s, {gen_s / steps * 1e3:.3f} ms per decode step, "
          f"{B * G / gen_s:.1f} generated tokens/s, "
          f"{B * steps / gen_s:.1f} tokens/s through the decoder; "
          f"launches={l_gen}")
    for r in range(B):
        print(f"  (b) row {r} generated: {new[r].tolist()}")
    check(out.shape == (B, P + G),
          f"generate shape {tuple(out.shape)}")
    check(torch.equal(out[:, :P], prompt), "prompt not kept")
    check(int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size,
          "a generated token lies outside the vocabulary")
    check(l_gen == none, f"decode launches {l_gen}")

    # every expert's capacity the whole group (C = Sg): a prefill drops no
    # token, as decode never does
    c_cfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe,
                                     capacity_factor=float(cfg.moe.n_experts)))
    c32_cfg = dataclasses.replace(c_cfg, compute_dtype="float32")

    def decode_last(c):
        """decode_step over the prompt; the logits at its last token."""
        with torch.inference_mode():
            caches = M.init_caches(c, B, P, dtype=torch.float32,
                                   device=DEVICE)
            for t in range(P):
                logits, caches = M.decode_step(
                    params, {"tokens": prompt[:, t:t + 1], **decode_extra},
                    caches, c)
        return logits[:, 0].float()

    prompt_batch = {"tokens": prompt, **extra.get("prompt", {})}
    with replay_routing() as routing:
        dec = decode_last(c_cfg)
        routes = routing.take()
        dec32 = decode_last(c32_cfg)
        routes32 = routing.take()
        routing.replay(routes, P)
        pre, _, _ = prefill(c_cfg, prompt_batch, reps=0)
        flips, drops = routing.taken()
        routing.replay(routes, P)
        pre32_same, _, _ = prefill(c32_cfg, prompt_batch, reps=0)
        drops += routing.taken()[1]
        routing.replay(routes32, P)
        pre32, _, _ = prefill(c32_cfg, prompt_batch, reps=0)
        flips32, drops32 = routing.taken()
    drops += drops32
    d_dec = float((dec - pre).abs().max())
    d_bf16 = float((pre - pre32_same).abs().max())
    d32 = float((dec32 - pre32).abs().max())
    same = int((dec.argmax(-1) == pre.argmax(-1)).sum())
    print(f"  (c) decode vs plain prefill at the last prompt token"
          + ("" if cfg.moe is None else
             f" (capacity factor {c_cfg.moe.capacity_factor}, the prefill "
             f"routing each token as its decode step did; {drops} slots "
             f"dropped)")
          + f": max |d|={d_dec!r} (limit 2 x {d_bf16!r}, the bf16 prefill's "
          f"distance from f32); decode vs f32 prefill "
          f"{float((dec - pre32_same).abs().max())!r}; greedy tokens agree "
          f"{same} of {B}")
    print(f"  (c) in f32: decode vs prefill max |d|={d32!r} (limit 5e-4 + "
          f"1e-3 |prefill|, the reference's test bounds)"
          + ("" if cfg.moe is None else
             f"; tokens whose own experts differ from their decode step's, "
             f"per MoE layer: bf16 {flips}, f32 {flips32} (limit 0)"))
    check(bool(torch.isfinite(dec).all() and torch.isfinite(dec32).all()),
          "non-finite decode logits")
    check(drops == 0, f"the prefills dropped {drops} slots at capacity")
    check(d_dec <= 2 * d_bf16, f"decode {d_dec} from prefill > 2 x {d_bf16}")
    check(bool(((dec32 - pre32).abs() <= 5e-4 + 1e-3 * pre32.abs()).all()),
          f"f32 decode {d32} from the f32 prefill")
    check(not any(flips32), f"f32 decode and prefill route tokens "
                            f"differently: {flips32}")
    del dec32
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) at "
          f"depth {cfg.n_layers} of {cfg.name}")
    del params, extra, batch, decode_extra, prompt_batch
    release()
    return {"launches": {k: l_flash[k] + l_plain[k] + l_gen[k]
                         for k in COUNTS},
            "n_params": n_params, "n_active": n_active, "init_s": init_s,
            "reserved_after_init": reserved, "n_layers": cfg.n_layers,
            "prefill_ms": {"flash": ms_flash, "plain": ms_plain,
                           "f32": ms_f32},
            "decode_ms_per_step": gen_s / steps * 1e3,
            "generated_tokens_per_s": B * G / gen_s,
            "peak_bytes": peak, "d_flash": d_flash, "d_plain": d_plain,
            "d_decode": d_dec, "d_decode_f32": d32, "route_flips": flips,
            "route_flips_f32": flips32}


def set_numerics() -> None:
    """TF32 off, cuDNN deterministic and not benchmarking."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels import qsgd_quant as qq

    device = torch.device(DEVICE)
    card = card_line()
    phase_s, since = {}, [time.perf_counter()]
    # the host-only work (phase 2's CPU uniform draw, phase 16's fake-mesh
    # dry runs) starts now and runs beside the card's phases
    atexit.register(stop_cpu_jobs)
    uniform_job = start_cpu_job([str(ROOT / "chip_smoke.py"),
                                 "--cpu-uniform"], threads=4)
    dry_jobs = start_dryruns()
    remat_job = start_cpu_job([str(ROOT / "chip_smoke.py"),
                               "--remat-peaks"])

    def done(name: str) -> None:
        """Print and keep the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - since[0]
        since[0] = now
        print(f"  phase {name}: {phase_s[name]:.1f} s")

    # the first activation checkpoint imports torch._dynamo (seconds):
    # import it while phase 1 waits on nvcc
    import threading
    warm = threading.Thread(target=__import__, args=("torch._dynamo",))
    warm.start()
    print(f"phase 1: environment  card: {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = (pv.SOURCE, qq.SOURCE, fa.SOURCE)
    reports = build.build(*sources)
    print(f"  built {[build.library_path(s).name for s in sources]}"
          f" in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, report in reports.items():
        for line in report.splitlines():
            print(f"  nvcc {name}: {line}")
    spills = [f"{name}: {line.strip()}" for name, report in reports.items()
              for line in report.splitlines()
              if any(int(n) for n in re.findall(
                  r"(\d+) bytes spill (?:stores|loads)", line))]
    print(f"  register spills in the -Xptxas -v reports: {spills or 'none'}")
    check(not spills, f"a kernel spills registers: {spills}")
    set_numerics()
    warm.join()
    print(f"  allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; cudnn "
          f"deterministic={torch.backends.cudnn.deterministic} "
          f"benchmark={torch.backends.cudnn.benchmark}")
    done("1")

    print("phase 2: kernels against their plain versions")
    errs = phase_kernels(device)
    gerrs = phase_grouped_kernels(device)
    qerrs = phase_qsgd_kernels(device)
    card_uniform = qerrs.pop("uniform")
    ferrs = phase_flash_kernels(device)
    done("2")

    print("phase 3: ADPSGD, OLMo-1B full width, 4 layers, R=4")
    main_path = phase_main_path()
    main_ref = dict(main_path.pop("resume_ref"), ms=main_path["ms"])
    release()
    done("3")
    print("phase 3b: qsgd_periodic, OLMo-1B full width, 4 layers, R=4")
    qp = phase_qsgd_periodic()
    qp_ref = qp.pop("mesh_ref")
    release()
    done("3b")
    print("phase 3c: qsgd, OLMo-1B full width, 4 layers, R=4")
    qs = phase_qsgd()
    check_uniform(card_uniform, uniform_job)
    done("3c")

    print(f"phase 4: kernel timings  card: {card}")
    W = qs.pop("W")
    timing = phase_timing(W)
    qtiming = phase_qsgd_timing(W)
    del W
    release()
    ftiming = phase_flash_timing()
    done("4")

    print("phase 5: serving, OLMo-1B full width, 16 layers")
    serving = phase_serving()
    done("5")

    print(f"phase 6: the telemetry clock, OLMo-1B full width, 4 layers, R=4"
          f"  card: {card}")
    clock = phase_clock(main_path)
    done("6")
    print("phase 7: hier_adpsgd, dasgd, adacomm (time blocks), OLMo-1B full "
          "width, 4 layers, R=4")
    strategies = phase_strategies()
    dasgd_ref = strategies["dasgd"].pop("resume_ref")
    hier_ref = strategies["hier_adpsgd"].pop("mesh_ref")
    done("7")
    # phase 8 and phases 15 and 15b's CLI runs run in processes of their
    # own on the card beside phase 9 (its checkpoint I/O is host work) and
    # end before phase 15: phase 9 alone is timed beside them
    import os
    import tempfile
    print(f"phase 9: checkpoint / resume, OLMo-1B full width, 4 layers, R=4 "
          f"(no cut)  card: {card}; phase 8 and the CLI runs of phases 15 "
          f"and 15b in processes of their own beside it (phase 9's times "
          f"are taken beside them, on a time-shared card)")
    co_resident = co_resident_check(main_path, strategies)
    fd, cnn_path = tempfile.mkstemp(prefix="chip_smoke_cnn_", suffix=".pt")
    os.close(fd)
    atexit.register(Path(cnn_path).unlink, missing_ok=True)
    cnn_job = start_cnn(cnn_path)
    clis = {"ddp": start_mesh_cli(), "tp": start_mesh_cli(TP_FLAGS + ["1"])}
    least = least_free()
    resume = phase_resume(main_ref, dasgd_ref)
    done("9")
    print(f"phase 8: the paper's CNN experiment, 9 strategies x 10 / 100 "
          f"Gbps (run beside phase 9)  card: {card}")
    for job in clis.values():
        wait_job(job)
    co_resident["least_free"] = least()
    print(f"  the card's least free memory while the four processes shared "
          f"it: {co_resident['least_free']} B "
          f"({co_resident['least_free'] / 2**30:.2f} GiB)")
    cnn = finish_cnn(cnn_job, cnn_path)
    resume["co_resident"] = co_resident
    done("8")
    print(f"phase 15: the mesh backend over NCCL (world 1), OLMo-1B full "
          f"width, 4 layers, R=4, against phases 3, 3b and 7  card: {card}")
    refs = {"adpsgd": main_ref, "qsgd_periodic": qp_ref,
            "dasgd": dasgd_ref, "hier_adpsgd": hier_ref}
    mesh = phase_mesh(refs, clis["ddp"])
    release()
    done("15")
    print(f"phase 15b: the mesh's replica_tp placement over NCCL (world 1, "
          f"model axis 1, DTensor steps), OLMo-1B full width, 4 layers, "
          f"R=4, against phases 3, 3b, 7 and 15  card: {card}")
    mesh_tp = phase_mesh_tp(refs, mesh, clis["tp"])
    del main_ref, qp_ref, dasgd_ref, hier_ref, refs
    release()
    done("15b")
    print(f"phase 16: the dry run's counts against the card (OLMo-1B full "
          f"width, 4 layers, R=4; the 16-layer prefill; the fake 32 x 8 mesh)"
          f"  card: {card}")
    dry = phase_dryrun(card, dry_jobs)
    done("16")
    print(f"phase 10: serving MiniCPM-2B, GLM4-9B, Qwen2.5-14B at full width "
          f"and depth  card: {card}")
    dense = phase_dense_serving()
    done("10")
    print(f"phase 11: ADPSGD, DeepSeek-V2-Lite full width, 2 layers (cut from "
          f"27), R=4  card: {card}")
    deepseek = phase_deepseek_training()
    done("11")
    print(f"phase 12: serving DeepSeek-V2-Lite at full width and depth, "
          f"Mixtral-8x22B at full width, 4 of 56 layers  card: {card}")
    moe_serving = phase_moe_serving()
    done("12")
    print(f"phase 13a: ADPSGD, Qwen2-VL-2B full width and depth (no cut), "
          f"R=4, momentum  card: {card}")
    qwen_vl = model_training("qwen2-vl-2b", QWEN_VL_ARGV)
    done("13a")
    print(f"phase 13b: ADPSGD, Whisper-medium full width and depth (no cut), "
          f"R=4, adamw, 1500 frames  card: {card}")
    whisper = model_training("whisper-medium", WHISPER_ARGV,
                             setup=add_frames)
    done("13b")
    print(f"phase 13c: serving Qwen2-VL-2B and Whisper-medium at full width "
          f"and depth  card: {card}")
    vlm_audio_serving = phase_vlm_audio_serving()
    done("13c")
    print(f"phase 14a: ADPSGD, xLSTM-350M full width and depth (no cut), "
          f"R=4, adamw  card: {card}")
    xlstm = model_training("xlstm-350m", XLSTM_ARGV)
    done("14a")
    print(f"phase 14b: ADPSGD, Jamba-1.5-Large full width, cut to 1 of 72 "
          f"layers (layer 0: Mamba + dense MLP), R=2 (cut from 4), adamw  "
          f"card: {card}")
    jamba = model_training("jamba-1.5-large-398b", JAMBA_ARGV)
    done("14b")
    print(f"phase 14c: serving xLSTM-350M at full width and depth, "
          f"Jamba-1.5-Large at full width, 5 of 72 layers, bf16 parameters"
          f"  card: {card}")
    ssm_serving = phase_ssm_serving()
    done("14c")
    print(f"phase 17: ADPSGD under remat, OLMo-1B full width and depth "
          f"(16 layers), {REMAT_BATCH} x {REMAT_SEQ} tokens a replica, "
          f"R={REMAT_R}, adamw; off / nothing / dots at {REMAT_B_LAYERS} "
          f"layers  card: {card}")
    remat = phase_remat(card, remat_job)
    done("17")

    training = {"adpsgd": main_path, "qsgd_periodic": qp, "qsgd": qs}
    paths = dict(training, serving=serving, clock=clock, **strategies,
                 cnn=cnn, resume=resume, dense_serving=dense,
                 deepseek_training=deepseek, moe_serving=moe_serving,
                 qwen_vl_training=qwen_vl, whisper_training=whisper,
                 vlm_audio_serving=vlm_audio_serving, xlstm_training=xlstm,
                 jamba_training=jamba, ssm_serving=ssm_serving, mesh=mesh,
                 mesh_tp=mesh_tp, dryrun=dry, remat_training=remat)
    launches = {k: sum(p["launches"][k] for p in paths.values())
                for k in COUNTS}
    print("launches by path: " + json.dumps(
        {name: p["launches"] for name, p in paths.items()}))
    sync = timing["sync"]
    kernels = [{
        "name": "mean_and_sqdev", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mean_sqdev.cu",
        "replaces": "src/repro/kernels/param_variance.py:47",
        "launches": launches["mean_and_sqdev"], "leaves": launches[LEAVES],
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
    row = ftiming["olmo_prefill"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": launches["flash_attention"],
        "max_abs_err": ferrs["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    print("summary: " + json.dumps({
        name: {k: p[k] for k in ("ms", "peak_bytes", "n_syncs")}
        for name, p in training.items()}))
    print("summary: mean_and_sqdev sync timing " + json.dumps(
        {"olmo": timing["sync"], "cnn": cnn["timing"]["sync"],
         "deepseek": deepseek["timing"]["sync"],
         "qwen2-vl-2b": qwen_vl["timing"]["sync"],
         "whisper-medium": whisper["timing"]["sync"],
         "xlstm-350m": xlstm["timing"]["sync"],
         "jamba-1.5-large-398b": jamba["timing"]["sync"],
         "dasgd_snapshot": strategies["dasgd"]["snapshot_timing"]}))
    print("summary: grouped mean_and_sqdev checks " + json.dumps(
        {"phase 2": gerrs, "olmo": main_path["grouped"],
         "cnn": cnn["grouped"], "deepseek": deepseek["grouped"],
         "qwen2-vl-2b": qwen_vl["grouped"],
         "whisper-medium": whisper["grouped"], "xlstm-350m": xlstm["grouped"],
         "jamba-1.5-large-398b": jamba["grouped"]}))
    print(f"summary: mean_and_sqdev embed={timing['embed']} "
          f"uniform_ms_per_exchange={qtiming['uniform_ms']} "
          f"qsgd_periodic last-sync s_k_rel={qp['s_k_rel']} "
          f"level_flips={qp['level_flips']}")
    print("summary: uniform chunking " + json.dumps(qtiming["chunking"]))
    print("summary: serving " + json.dumps(
        {k: v for k, v in serving.items() if k != "launches"})
          + f" flash prefill_32k={ftiming['prefill_32k']}")
    print("summary: resume " + json.dumps(
        {k: v for k, v in resume.items() if k != "launches"}))
    print("summary: dense serving " + json.dumps(
        {arch: {k: v for k, v in dense[arch].items() if k != "launches"}
         for arch in DENSE_ARCHS}))
    print("summary: flash timing " + json.dumps(ftiming)
          + " wgmma instance vs plain " + json.dumps(ferrs["wgmma"]))
    print("summary: deepseek training " + json.dumps(
        {k: deepseek[k] for k in ("ms", "peak_bytes", "n_syncs", "n_params",
                                  "s_k_rel", "aux", "timing")}))
    print("summary: moe serving " + json.dumps(
        {arch: {k: v for k, v in moe_serving[arch].items() if k != "launches"}
         for arch in MOE_SERVE}))
    print("summary: vlm / audio training " + json.dumps(
        {name: {k: p[k] for k in ("ms", "peak_bytes", "n_syncs", "n_params",
                                  "s_k_rel", "timing")}
         for name, p in (("qwen2-vl-2b", qwen_vl),
                         ("whisper-medium", whisper))}))
    print("summary: vlm / audio serving " + json.dumps(
        {arch: {k: v for k, v in vlm_audio_serving[arch].items()
                if k != "launches"} for arch in VLM_AUDIO_ARCHS}))
    print("summary: ssm training " + json.dumps(
        {name: {k: p[k] for k in ("ms", "peak_bytes", "n_syncs", "n_params",
                                  "s_k_rel", "timing")}
         for name, p in (("xlstm-350m", xlstm),
                         ("jamba-1.5-large-398b", jamba))}))
    print("summary: ssm serving " + json.dumps(
        {arch: {k: v for k, v in ssm_serving[arch].items()
                if k != "launches"} for arch in SSM_SERVE}))
    print("summary: mesh " + json.dumps(
        {k: v for k, v in mesh.items() if k != "launches"}, default=str))
    print("summary: mesh replica_tp " + json.dumps(
        {k: v for k, v in mesh_tp.items() if k != "launches"}, default=str))
    print("summary: dry run " + json.dumps(
        {k: v for k, v in dry.items() if k != "launches"}, default=str))
    print("summary: remat training " + json.dumps(
        {k: remat[k] for k in ("ms", "peak_bytes", "n_syncs", "n_params",
                               "s_k_rel", "meta", "policies")}))
    print("summary: phase seconds " + json.dumps(phase_s)
          + f" total {sum(phase_s.values()):.1f}")
    print("summary: clock " + json.dumps(
        {k: clock[k] for k in ("sim", "wall")}))
    print("summary: strategies " + json.dumps(
        {name: {k: v for k, v in p.items() if k != "launches"}
         for name, p in strategies.items()}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_tp_multi_gpu() -> int:
    """``python3 chip_smoke.py --tp-multi-gpu`` on a host of two GPUs or
    more: the kernels built, phase 3's ADPSGD run on GPU 0 as the vmap
    reference, then ``tp_multi_gpu`` (the CLI on 2 ranks, model axis 2,
    and on 4 ranks, data 2 × model 2, where there are 4 GPUs)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import param_variance as pv
    from repro_torch.kernels import qsgd_quant as qq

    card = card_line()
    print(f"multi-GPU replica_tp  card: {card}; "
          f"{torch.cuda.device_count()} GPUs, torch {torch.__version__}")
    build.build(pv.SOURCE, qq.SOURCE, fa.SOURCE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    run = drive(MAIN_ARGV)
    hist = run["hist"]
    ref = {"losses": hist.losses, "sync_steps": hist.sync_steps,
           "period_history": hist.period_history, "s_k": hist.s_k}
    del run, hist
    release()
    got = tp_multi_gpu(ref)
    check(got["ran"], "fewer than 2 GPUs")
    print(f"  multi-GPU replica_tp: {time.perf_counter() - t0:.1f} s")
    print("summary: multi-GPU replica_tp " + json.dumps(got, default=str))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main_tp_multi_gpu() if "--tp-multi-gpu" in sys.argv[1:]
             else main_cpu_uniform() if "--cpu-uniform" in sys.argv[1:]
             else main_remat_peaks() if "--remat-peaks" in sys.argv[1:]
             else main_cnn() if "--cnn" in sys.argv[1:]
             else main())
