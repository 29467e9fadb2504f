"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move the yardstick: the H100's published peaks, the byte
and operation counts of the port's sync and QSGD kernels (copied from
``repro_torch/kernels/cost.py``), the kernel-name categories (copied from
``repro_torch/launch/profile.py``) and the model FLOPs of a training step,
counted from a configuration file's shapes by its family's module
(``bench/archs/<model_type>.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from bench.archs import arch_of

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

Cost = Tuple[float, float]           # (bytes, operations)


def bound_s(n_bytes: float, n_ops: float,
            ops_per_s: float = F32_FLOPS_PER_S) -> float:
    """Least time on one card: the larger of the bytes over the memory
    rate and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def mean_sqdev_cost(shapes: Sequence[Sequence[int]]) -> Cost:
    """Mode "mean" over stacked (R, ...) buffers: each input read once,
    the mean written once; about 4 f32 operations an input element."""
    n_in = sum(math.prod(s) for s in shapes)
    n_out = sum(math.prod(s[1:]) for s in shapes)
    return (n_in + n_out) * 4, 4 * n_in


def fused_sync_cost(shapes: Sequence[Sequence[int]]) -> Cost:
    """Modes "sync" and "delta": each input read once and R values written
    back a column; about 4 f32 operations an input element."""
    n = sum(math.prod(s) for s in shapes)
    return 8 * n, 4 * n


def grouped_cost(shapes: Sequence[Sequence[int]], mode: str) -> Cost:
    """One grouped launch in ``mode``; the ``_to`` modes read the given
    mean besides."""
    if mode == "mean":
        return mean_sqdev_cost(shapes)
    n_bytes, n_ops = fused_sync_cost(shapes)
    if mode in ("sync_to", "delta_to"):
        n_bytes += 4 * sum(math.prod(s[1:]) for s in shapes)
    return n_bytes, n_ops


# per element: (bytes, operations)
QSGD_PER_ELEMENT = {"sqnorm": (4, 2), "quantize": (9, 8), "dequantize": (5, 1)}


def qsgd_cost(name: str, n: int) -> Cost:
    """sqnorm reads 4 bytes an element; quantize reads x and u and writes
    one int8 level; dequantize reads a level and writes 4 bytes."""
    n_bytes, n_ops = QSGD_PER_ELEMENT[name]
    return n_bytes * n, n_ops * n


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


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask lets through in one sequence."""
    return seq * (seq + 1) // 2


def train_flops_per_sequence(cfg: Dict, seq: int) -> int:
    """Model FLOPs of one training sequence: the forward (2 FLOPs a
    multiply-add of the family's weight matrices, ``bench/archs/``, and
    its token mixing's FLOPs) and the backward at twice the forward; the
    recompute of activation checkpointing is not counted."""
    arch = arch_of(cfg)
    forward = 2 * arch.matmul_macs_per_token(cfg) * seq \
        + arch.mixer_flops_per_sequence(cfg, seq)
    return 3 * forward
