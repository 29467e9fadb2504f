"""Blockwise (flash) attention, forward only (port of
``repro/kernels/flash_attention.py::flash_attention``).

The kernel is CUDA C++ for Hopper, ``csrc/flash_attention.cu``, built and
loaded by ``kernels/build.py`` at first use; nothing is compiled when this
module is imported.  bf16 at head dims 64 and 128 runs on the tensor cores
(``wgmma`` with TMA loads); f32, and bf16 at d = 32, run on the CUDA
cores (f32's tolerance is beyond bf16 or tf32 products).
``flash_attention`` checks its inputs, sends CPU tensors to the plain
version (``kernels/ref.py::attention_ref``) and launches the kernel for
CUDA tensors — there is no fallback: a kernel that
fails to build or launch raises.  Each launch adds one to
``flash_attention.launches``.

The reference has no gradient for its kernel, so neither has the port:
the wrapper refuses inputs that require one while grad mode is on.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

SOURCE = build.CSRC / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)       # the kernel's instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return build.load(SOURCE, {
        "repro_flash_attention": (p, p, p, p, i32, i32, i32, i32, i32, i32,
                                  i32, *(i64,) * 9, ctypes.c_float, i32, i32,
                                  p)})


def check_lengths(Sq: int, Sk: int, block_q: int = 128,
                  block_k: int = 128) -> None:
    """The reference tiles q and k by min(block, length) and refuses a
    length that is not a multiple of its tile
    (``flash_attention.py:83``); the port refuses the same lengths."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(
            f"flash_attention: lengths Sq={Sq}, Sk={Sk} are not multiples "
            f"of the tiles ({bq}, {bk}) that block_q={block_q}, "
            f"block_k={block_k} give")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,Sq,H,d) and k, v "
                         f"(B,Sk,K,d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (H % K must be 0)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention takes float32 or bfloat16 "
                            f"q, k, v of one dtype; {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if t.device != q.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention: {name} lies on {t.device}; "
                             f"q, k, v must share one cuda or cpu device")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient (the reference's Pallas kernel "
            "has none either): call it under torch.no_grad() or "
            "torch.inference_mode(), or train with use_flash=False")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,Sk,K,d) with H % K == 0 (kv head h // (H/K)
    serves q head h).  Causal and/or sliding-window softmax attention,
    output (B,Sq,H,d) in q's dtype.  ``block_q`` and ``block_k`` decide only
    which lengths are accepted, as in the reference; the kernel tiles on
    its own (128 x 128 on the tensor cores, 64 x 64 on the CUDA cores)."""
    _check(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    check_lengths(Sq, Sk, block_q, block_k)
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on a 16-byte "
                         "boundary")
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, K, Sq, Sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            1.0 / math.sqrt(d), int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
