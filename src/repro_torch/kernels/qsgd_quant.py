"""QSGD stochastic quantization kernels (port of
``repro/kernels/qsgd_quant.py``: ``sqnorm``, ``quantize``, ``dequantize``).

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

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_ref, qsgd_scale, quantize_ref,
                                     sqnorm_ref)

SOURCE = build.CSRC / "qsgd_quant.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return build.load(SOURCE, {
        "repro_qsgd_sqnorm_f32": (p, p, p, i64, i32, p),
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


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Σ x² of an f32 tensor, as an f32 scalar tensor on x's device."""
    _check(x, "x", torch.float32)
    if x.device.type == "cpu":
        return sqnorm_ref(x)
    n = x.numel()
    blocks = build.grid_blocks(n)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    sq = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().repro_qsgd_sqnorm_f32(
            x.data_ptr(), partials.data_ptr(), sq.data_ptr(), n, blocks,
            _stream(x))
    build.check(err, "qsgd sqnorm")
    sqnorm.launches += 1
    return sq


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
