"""Fused replica-mean + variance-probe kernel (port of
``repro/kernels/param_variance.py::mean_and_sqdev``).

The kernel is CUDA C++ for Hopper, ``csrc/mean_sqdev.cu``, built and
loaded by ``kernels/build.py`` at first use; nothing is compiled when this
module is imported.  ``mean_and_sqdev`` sends a CPU tensor to the plain
version (``kernels/ref.py``) and launches the kernel for a CUDA tensor —
there is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mean_and_sqdev_ref

SOURCE = build.CSRC / "mean_sqdev.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    return build.load(SOURCE, {
        "repro_mean_sqdev_f32": (p, p, p, p, i64, i64, ctypes.c_int, p)})


def mean_and_sqdev(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (R, ...) f32, one stacked-replica buffer.  Returns (mean of shape
    ``w.shape[1:]`` in f32, Σ_i ||mean − w_i||² as an f32 scalar tensor).
    Divide the scalar by R for the paper's S_k contribution.  Each launch
    of the CUDA kernel adds one to ``mean_and_sqdev.launches``."""
    if w.dtype != torch.float32:
        raise TypeError(f"mean_and_sqdev takes float32, got {w.dtype}")
    if w.dim() < 1 or w.numel() == 0:
        raise ValueError(f"mean_and_sqdev needs a non-empty (R, ...) "
                         f"tensor, got shape {tuple(w.shape)}")
    if w.device.type == "cpu":
        return mean_and_sqdev_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"mean_and_sqdev runs on cuda or cpu, not "
                         f"{w.device}")
    if not w.is_contiguous():
        raise ValueError("mean_and_sqdev needs a contiguous tensor")
    rows = w.shape[0]
    cols = w.numel() // rows
    blocks = build.grid_blocks(cols)
    mean = torch.empty(w.shape[1:], dtype=torch.float32, device=w.device)
    partials = torch.empty(blocks, dtype=torch.float32, device=w.device)
    sq = torch.empty((), dtype=torch.float32, device=w.device)
    lib = _library()
    with torch.cuda.device(w.device):
        err = lib.repro_mean_sqdev_f32(
            w.data_ptr(), mean.data_ptr(), partials.data_ptr(),
            sq.data_ptr(), rows, cols, blocks,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "mean_sqdev")
    mean_and_sqdev.launches += 1
    return mean, sq


mean_and_sqdev.launches = 0
