"""Plain PyTorch versions of the port's kernels (the CPU route of each
wrapper, and what ``chip_smoke.py`` holds each CUDA kernel against)."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,Sk,K,d), H % K == 0.  Exact softmax
    attention: f32 logits scaled by 1/√d, −1e30 where the mask fails
    (positions aligned at the top left: key j <= query i if ``causal``,
    j > i − window if ``window``), softmax, output in q's dtype."""
    B, Sq, H, d = q.shape
    _, Sk, K, _ = k.shape
    qh = q.reshape(B, Sq, K, H // K, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return o.reshape(B, Sq, H, d).to(q.dtype)


def mean_and_sqdev_ref(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (R, ...) -> (f32 mean over axis 0, Σ_i ||mean − w_i||² f32).
    The mean sums the replicas in index order and divides by R, as the
    CUDA kernel does (and ``torch.mean`` on the CPU); ``torch.mean`` on
    the card adds them in another order in some elements, an ulp apart,
    and where the replicas differ by a few ulps (a late sync at a small
    lr) that ulp moves Σ ||mean − w_i||² by 1e-4 of itself."""
    wf = w.reshape(w.shape[0], -1).to(torch.float32)
    mean = wf[0].clone()
    for x in wf[1:]:
        mean += x
    mean /= wf.new_tensor(float(wf.shape[0]))   # a true division on the card
    sq = (wf - mean[None]).square().sum()
    return mean.reshape(w.shape[1:]), sq


def mean_and_sqdev_many_ref(leaves: Sequence[torch.Tensor], mode: str,
                            out: Optional[Sequence[torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean_and_sqdev_ref`` per leaf, then the mode's write: "mean" the
    mean into ``out[l]``, "sync" the mean into every replica of the leaf,
    "delta" ``mean − w`` into ``out[l]`` (the leaf's shape).  Returns
    (each leaf's sq stacked, Σ_l sq_l / R summed in leaf order)."""
    sks = []
    for i, x in enumerate(leaves):
        mean, sk = mean_and_sqdev_ref(x)
        if mode == "sync":
            x.copy_(mean.unsqueeze(0).expand_as(x))
        elif mode == "mean":
            out[i].copy_(mean)
        else:
            torch.sub(mean.unsqueeze(0), x, out=out[i])
        sks.append(sk)
    return torch.stack(sks), sum(sks) / leaves[0].shape[0]


def qsgd_scale(bits: int) -> int:
    """s = 2^(bits−1) − 1, the largest QSGD level."""
    if not 2 <= bits <= 8:
        raise ValueError(f"QSGD levels are int8: bits must lie in [2, 8], "
                         f"got {bits}")
    return (1 << (bits - 1)) - 1


def sqnorm_ref(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in f32, as a scalar tensor."""
    return x.to(torch.float32).square().sum()


def sqnorm_many_ref(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqnorm_ref`` of each tensor of ``xs``, stacked: shape (len(xs),)."""
    return torch.stack([sqnorm_ref(x) for x in xs])


def quantize_ref(x: torch.Tensor, u: torch.Tensor, bits: int = 8,
                 norm: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QSGD with external uniforms u: (int8 levels of x's shape, f32 norm).
    ``norm`` defaults to ||x||₂; a zero norm gives zero levels.  A level of
    s + 1 (reachable when |x|/norm rounds just above 1) is clamped to the
    int8 range before the cast, as XLA's saturating cast does."""
    s = qsgd_scale(bits)
    xf = x.to(torch.float32)
    if norm is None:
        norm = torch.sqrt(sqnorm_ref(xf))
    norm = norm.reshape(())
    scaled = torch.where(norm > 0, xf.abs() / norm * s,
                         torch.zeros((), dtype=torch.float32,
                                     device=x.device))
    floor = torch.floor(scaled)
    mag = floor + (u < (scaled - floor)).to(torch.float32)
    levels = (torch.sign(xf) * mag).clamp_(-128, 127).to(torch.int8)
    return levels, norm


def dequantize_ref(levels: torch.Tensor, norm: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """levels · (norm / s) in f32.  s is a tensor on norm's device: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which rounds differently from the division."""
    s = torch.full((), qsgd_scale(bits), dtype=torch.float32,
                   device=norm.device)
    return levels.to(torch.float32) * (norm.reshape(()) / s)
