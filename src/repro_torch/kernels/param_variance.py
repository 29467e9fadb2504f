"""Fused replica-mean + variance-probe kernel (port of
``repro/kernels/param_variance.py::mean_and_sqdev``).

The kernel is CUDA C++ for Hopper, ``csrc/mean_sqdev.cu``.  It is compiled
with ``nvcc`` at first use into ``build/repro_torch/`` at the root of the
checkout (the file name carries a hash of the source, so an edited source
is rebuilt) and loaded with ``ctypes``; nothing is compiled when this
module is imported.  ``mean_and_sqdev`` sends a CPU tensor to the plain
version (``kernels/ref.py``) and launches the kernel for a CUDA tensor —
there is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.ref import mean_and_sqdev_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mean_sqdev.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

THREADS = 256        # kThreads in the source
MAX_BLOCKS = 4096    # grid of pass 1; a function of N only (determinism)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmean_sqdev-{digest}.so"


def build() -> str:
    """Compile the kernel if this source has not been built yet; returns
    the compiler's resource report (``-Xptxas -v``), empty when the
    library was already there."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none
    return proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    fn = lib.repro_mean_sqdev_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def grid_blocks(n_cols: int) -> int:
    return max(1, min(-(-n_cols // THREADS), MAX_BLOCKS))


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
    blocks = grid_blocks(cols)
    mean = torch.empty(w.shape[1:], dtype=torch.float32, device=w.device)
    partials = torch.empty(blocks, dtype=torch.float32, device=w.device)
    sq = torch.empty((), dtype=torch.float32, device=w.device)
    lib = _library()
    with torch.cuda.device(w.device):
        err = lib.repro_mean_sqdev_f32(
            w.data_ptr(), mean.data_ptr(), partials.data_ptr(),
            sq.data_ptr(), rows, cols, blocks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mean_sqdev kernel launch failed: CUDA error "
                           f"{err}")
    mean_and_sqdev.launches += 1
    return mean, sq


mean_and_sqdev.launches = 0
