"""Core neural-net layers (port of the dense subset of
``repro/models/layers.py``).

Functional, as the reference: ``init_*`` builds a parameter tree (nested
dicts of tensors), ``*_forward`` consumes it.  The weight layout is the
reference's — dense ``w`` is ``(d_in, d_out)`` and the product is
``x @ w`` — so reference parameters copy across with no transposes.
Attention is the full-sequence, cache-free path and the MLP is SwiGLU; the
flash-attention kernel, MLA, M-RoPE, MoE and the gelu MLP come with later
parts of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, dtype,
               bias: bool = False) -> Params:
    w = torch.randn(d_in, d_out, generator=gen,
                    device=gen.device) / math.sqrt(d_in)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(gen: torch.Generator, cfg: ModelConfig, d: int) -> Params:
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dt, device=dev)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=dt, device=dev),
                "bias": torch.zeros(d, dtype=dt, device=dev)}
    if cfg.norm_type == "nonparametric_ln":   # OLMo: no parameters
        return {}
    raise ValueError(cfg.norm_type)


def norm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    eps = cfg.norm_eps
    xf = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm_type == "layernorm":
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                         device=device) / rotary_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (B,S,H,dh); pos: (B,S) int.  Rotates the first
    ``rotary_frac * dh`` dims (half-split convention)."""
    dh = x.shape[-1]
    rd = int(dh * rotary_frac)
    rd -= rd % 2
    inv = rope_freqs(rd, theta, x.device)                    # (rd/2,)
    ang = pos[..., None].to(torch.float32) * inv             # (B,S,rd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, full sequence)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg.param_dtype)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    b = cfg.attn_qkv_bias
    return {
        "wq": dense_init(gen, D, H * dh, dtype=dt, bias=b),
        "wk": dense_init(gen, D, K * dh, dtype=dt, bias=b),
        "wv": dense_init(gen, D, K * dh, dtype=dt, bias=b),
        "wo": dense_init(gen, H * dh, D, dtype=dt),
    }


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q:(B,Sq,H,dh) k,v:(B,Sk,K,dv) grouped-query attention core: f32
    logits, −1e30 mask, softmax, in the reference's einsum form."""
    B, Sq, H, dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    q = q.reshape(B, Sq, Kh, G, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(dh)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """q_pos (B,Sq), k_pos (B,Sk) -> (B,Sq,Sk) bool."""
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    m &= k_pos[:, None, :] >= 0
    if window:
        m &= k_pos[:, None, :] > q_pos[:, :, None] - window
    return m


def attention_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the full sequence x (B,S,D)."""
    B, S, _ = x.shape
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    if cfg.use_flash and cfg.sliding_window == 0 and S > 1:
        raise NotImplementedError(
            "use_flash: the flash-attention kernel is not ported yet")
    q = dense(p["wq"], x).reshape(B, S, H, dh)
    k = dense(p["wk"], x).reshape(B, S, Kh, dh)
    v = dense(p["wv"], x).reshape(B, S, Kh, dh)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    mask = _causal_mask(positions, positions, cfg.sliding_window)
    out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    return dense(p["wo"], out.reshape(B, S, H * dh))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """SwiGLU (every dense config but whisper's gelu, which comes with the
    audio family)."""
    dt = dtype_of(cfg.param_dtype)
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, D, Fd, dtype=dt),
        "w_up": dense_init(gen, D, Fd, dtype=dt),
        "w_down": dense_init(gen, Fd, D, dtype=dt),
    }


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU."""
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x))
                 * dense(p["w_up"], x))
