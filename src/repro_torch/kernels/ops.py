"""Public wrappers for the port's kernels: the model and the sync call
these, never a kernel module directly.  Each wrapper launches its CUDA
kernel for a CUDA tensor and uses the plain version for a CPU tensor."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import param_variance as _pv
from repro_torch.kernels import qsgd_quant as _qq


def param_mean_and_sqdev(w):
    return _pv.mean_and_sqdev(w)


def param_mean_and_sqdev_many(leaves, mode: str = "sync", out=None,
                              mean=None, divisor: int = 1):
    return _pv.mean_and_sqdev_many(leaves, mode, out, mean, divisor)


def param_mean_and_sqdev_out(leaves, mode: str):
    """A flat output buffer for ``param_mean_and_sqdev_many`` in ``mode``
    ("mean", "delta" or "delta_to") and each leaf's view of it."""
    out = _pv.new_out(leaves, mode)
    return out, _pv.out_views(out, leaves, mode)


def qsgd_sqnorm(x):
    return _qq.sqnorm(x)


def qsgd_sqnorm_many(xs):
    return _qq.sqnorm_many(xs)


def qsgd_quantize(x, u, norm, bits: int = 8):
    return _qq.quantize(x, u, norm, bits)


def qsgd_quantize_keyed(x, key, norm, bits: int = 8):
    return _qq.quantize_keyed(x, key, norm, bits)


def qsgd_dequantize(levels, norm, bits: int = 8):
    return _qq.dequantize(levels, norm, bits)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_k=block_k)
