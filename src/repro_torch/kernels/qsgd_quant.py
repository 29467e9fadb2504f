"""QSGD stochastic quantization kernels (port of
``repro/kernels/qsgd_quant.py``: ``sqnorm``, ``quantize``, ``dequantize``;
``sqnorm_many`` takes the squared norms of a group of tensors in one
launch, and ``sqnorm`` is its group of one).

The kernels are CUDA C++ for Hopper, ``csrc/qsgd_quant.cu``, built and
loaded by ``kernels/build.py`` at first use; nothing is compiled when this
module is imported.  Each wrapper checks its inputs, sends CPU tensors to
the plain version (``kernels/ref.py``) and launches the kernel for CUDA
tensors — there is no fallback: a kernel that fails to build or launch
raises.  Each launch adds one to the wrapper's ``launches`` count.

The uniforms of the stochastic rounding are an input, as in the reference,
and the norm a device scalar: ``quantize`` takes the norm that ``sqnorm``
gave (after a square root), so the three launches never wait on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_ref, qsgd_scale, quantize_ref,
                                     sqnorm_many_ref)

SOURCE = build.CSRC / "qsgd_quant.cu"
MAX_GROUP = 64       # kMaxGroup in csrc/qsgd_quant.cu: tensors per launch


@functools.cache
def _library() -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return build.load(SOURCE, {
        "repro_qsgd_sqnorm_many_f32": (p, p, p, i32, p, p, p),
        "repro_qsgd_quantize_f32": (p, p, p, p, i64, i32, i32, p),
        "repro_qsgd_dequantize_i8": (p, p, p, i64, i32, i32, p),
    })


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must lie on cuda or cpu, not {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor")


def _check_norm(norm: torch.Tensor, like: torch.Tensor) -> None:
    _check(norm, "norm", torch.float32)
    if norm.numel() != 1 or norm.device != like.device:
        raise ValueError(f"norm must be one value on {like.device}, got "
                         f"shape {tuple(norm.shape)} on {norm.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sqnorm_many(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ x² of each f32 tensor of ``xs`` (all on one device), as an f32
    tensor of shape (len(xs),) on that device.  On the card: one launch
    per ``MAX_GROUP`` tensors, each adding one to ``sqnorm.launches``;
    each sum equals, bit for bit, what the tensor gives alone."""
    xs = list(xs)
    if not xs:
        raise ValueError("sqnorm_many needs at least one tensor")
    for x in xs:
        _check(x, "x", torch.float32)
        if x.device != xs[0].device:
            raise ValueError(f"sqnorm_many: tensors lie on {xs[0].device} "
                             f"and {x.device}; they must share one device")
    if xs[0].device.type == "cpu":
        return sqnorm_many_ref(xs)
    blocks = [build.grid_blocks(x.numel()) for x in xs]
    partials = torch.empty(sum(blocks), dtype=torch.float32,
                           device=xs[0].device)
    sq = torch.empty(len(xs), dtype=torch.float32, device=xs[0].device)
    lib, stream = _library(), _stream(xs[0])
    first = 0
    with torch.cuda.device(xs[0].device):
        for t0 in range(0, len(xs), MAX_GROUP):
            group, nb = xs[t0:t0 + MAX_GROUP], blocks[t0:t0 + MAX_GROUP]
            k = len(group)
            err = lib.repro_qsgd_sqnorm_many_f32(
                (ctypes.c_void_p * k)(*(x.data_ptr() for x in group)),
                (ctypes.c_longlong * k)(*(x.numel() for x in group)),
                (ctypes.c_int * k)(*nb), k,
                partials.data_ptr() + 4 * first, sq.data_ptr() + 4 * t0,
                stream)
            build.check(err, "qsgd sqnorm")
            sqnorm.launches += 1
            first += sum(nb)
    return sq


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Σ x² of an f32 tensor, as an f32 scalar tensor on x's device."""
    return sqnorm_many([x])[0]


def quantize(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    """int8 QSGD levels of the f32 tensor x, given its norm (one f32 value
    on x's device) and uniforms u of x's shape; a zero norm gives zero
    levels."""
    _check(x, "x", torch.float32)
    _check(u, "u", torch.float32)
    _check_norm(norm, x)
    if u.shape != x.shape or u.device != x.device:
        raise ValueError(f"u must match x: {tuple(u.shape)} on {u.device} "
                         f"vs {tuple(x.shape)} on {x.device}")
    s = qsgd_scale(bits)
    if x.device.type == "cpu":
        return quantize_ref(x, u, bits, norm=norm)[0]
    n = x.numel()
    levels = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().repro_qsgd_quantize_f32(
            x.data_ptr(), u.data_ptr(), norm.data_ptr(), levels.data_ptr(),
            n, s, build.grid_blocks(n), _stream(x))
    build.check(err, "qsgd quantize")
    quantize.launches += 1
    return levels


def dequantize(levels: torch.Tensor, norm: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """levels · norm / s as f32, of the levels' shape."""
    _check(levels, "levels", torch.int8)
    _check_norm(norm, levels)
    s = qsgd_scale(bits)
    if levels.device.type == "cpu":
        return dequantize_ref(levels, norm, bits)
    n = levels.numel()
    out = torch.empty(levels.shape, dtype=torch.float32, device=levels.device)
    with torch.cuda.device(levels.device):
        err = _library().repro_qsgd_dequantize_i8(
            levels.data_ptr(), norm.data_ptr(), out.data_ptr(), n, s,
            build.grid_blocks(n), _stream(levels))
    build.check(err, "qsgd dequantize")
    dequantize.launches += 1
    return out


sqnorm.launches = 0
quantize.launches = 0
dequantize.launches = 0
