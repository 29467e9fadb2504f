"""What each of the port's kernels costs: the bytes a call must move
(each input read once, each output written once), the operations it must
do, and the least time an H100 needs for them (``bound``).

``chip_smoke.py`` prints these bounds beside the kernels' measured times.
A dry run reads the same costs without a card: given tensors on the meta
device, each kernel wrapper builds and launches nothing, adds nothing to
its launch count, returns outputs of the right shapes and dtypes, and
reports its call through ``record`` to every active dispatch mode that
has a ``record_kernel(name, n_bytes, n_ops)`` method
(``launch/dryrun.py``'s ``CostMode``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

from repro_torch.core.comm_model import HBM_BW, PEAK_FLOPS_BF16

HBM_BYTES_PER_S = HBM_BW             # H100 SXM device memory
F32_FLOPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = PEAK_FLOPS_BF16   # H100 SXM bf16 tensor cores, dense
# H100 SXM 32-bit integer ALU: 132 SMs x 64 INT32 lanes x 1.98 GHz (the
# clock of the published f32 and bf16 rates)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

Cost = Tuple[float, float]           # (bytes, operations)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_FLOPS_PER_S) -> tuple:
    """Least time on the card: the larger of bytes over its memory rate and
    operations over the peak rate for their type (f32 unless given).
    Returns (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mean_sqdev_cost(shapes) -> Cost:
    """mean_and_sqdev over stacked buffers of ``shapes`` in mode mean: each
    input read once and the mean written once; about 4 f32 operations per
    input."""
    n_in = sum(math.prod(s) for s in shapes)
    n_out = sum(math.prod(s[1:]) for s in shapes)
    return (n_in + n_out) * 4, 4 * n_in


def mean_sqdev_bound(shapes) -> tuple:
    return bound(*mean_sqdev_cost(shapes))


def fused_sync_cost(shapes) -> Cost:
    """The grouped sync, or DaSGD's snapshot, over stacked buffers of
    ``shapes``: each input read once and R values written back for each
    column (the mean into every replica, or the deltas); about 4 f32
    operations per input."""
    n = sum(math.prod(s) for s in shapes)
    return 8 * n, 4 * n


def fused_sync_bound(shapes) -> tuple:
    return bound(*fused_sync_cost(shapes))


def grouped_cost(shapes, mode: str) -> Cost:
    """One ``mean_and_sqdev_many`` call in ``mode``: "mean" as
    ``mean_sqdev_cost``; "sync" and "delta" as ``fused_sync_cost``; the
    ``_to`` modes read the given mean besides."""
    if mode == "mean":
        return mean_sqdev_cost(shapes)
    n_bytes, n_ops = fused_sync_cost(shapes)
    if mode in ("sync_to", "delta_to"):
        n_bytes += 4 * sum(math.prod(s[1:]) for s in shapes)
    return n_bytes, n_ops


# per element: (bytes, operations)
QSGD_PER_ELEMENT = {"sqnorm": (4, 2), "quantize": (9, 8), "dequantize": (5, 1),
                    "quantize_keyed": (5, 43)}


def qsgd_cost(name: str, n: int) -> Cost:
    """Per element: sqnorm reads 4 bytes (2 operations); quantize reads x
    and u and writes one int8 level (about 8 operations); dequantize
    reads a level and writes 4 bytes (1 operation).  quantize_keyed reads
    x and writes a level; its operations are the threefry hash's 32-bit
    integer operations that only the integer ALU runs: 20 rotations, 21
    xors, and the shift and or that make the uniform's bits (its 32 adds
    may issue on the FMA pipe beside them, and its f32 work is
    quantize's)."""
    n_bytes, n_ops = QSGD_PER_ELEMENT[name]
    return n_bytes * n, n_ops * n


def qsgd_bound(name: str, n: int) -> tuple:
    """``bound`` of ``qsgd_cost``: quantize_keyed's operations at the
    integer ALU's rate, the others' at the f32 rate."""
    return bound(*qsgd_cost(name, n), INT32_OPS_PER_S
                 if name == "quantize_keyed" else F32_FLOPS_PER_S)


@functools.lru_cache(maxsize=256)
def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    total = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window else 0
        hi = min(Sk - 1, i) if causal else Sk - 1
        total += max(0, hi - lo + 1)
    return total


def flash_cost(B: int, Sq: int, Sk: int, H: int, K: int, d: int,
               causal: bool = True, window: int = 0, elt: int = 2
               ) -> Tuple[float, float, float]:
    """flash attention on q (B, Sq, H, d) and k, v (B, Sk, K, d): q, k, v
    read once and o written once; 4·d FLOPs (two multiply-adds per element
    of q·k and p·v) for each pair the mask lets through.  Returns
    (bytes, FLOPs, the peak rate for the inputs' type: the bf16 tensor
    cores for bf16, f32 otherwise)."""
    n_bytes = (2 * B * Sq * H * d + 2 * B * Sk * K * d) * elt
    n_ops = 4 * d * B * H * attention_pairs(Sq, Sk, causal, window)
    return n_bytes, n_ops, (BF16_FLOPS_PER_S if elt == 2
                            else F32_FLOPS_PER_S)


def flash_bound(shape, causal: bool = True, window: int = 0,
                elt: int = 2) -> tuple:
    """``flash_cost``'s bound for (B, S, H, K, d), self-attention."""
    B, S, H, K, d = shape
    return bound(*flash_cost(B, S, S, H, K, d, causal, window, elt))


def record(name: str, n_bytes: float, n_ops: float, reads=(),
           writes=()) -> None:
    """Report one kernel call made on the meta device to every active
    dispatch mode that records kernel calls: its bytes and operations,
    and the tensors it reads and writes (the meta branch touches no
    storage, so a recorder sees them only here)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "record_kernel", None)
        if hook is not None:
            hook(name, n_bytes, n_ops, reads, writes)
