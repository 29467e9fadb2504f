"""Core neural-net layers (port of the dense subset of
``repro/models/layers.py``).

Functional, as the reference: ``init_*`` builds a parameter tree (nested
dicts of tensors) from a ``core/prng.py`` key, split and drawn as the
reference's ``jax.random`` key, and ``*_forward`` consumes it.  The weight layout is the
reference's — dense ``w`` is ``(d_in, d_out)`` and the product is
``x @ w`` — so reference parameters copy across with no transposes.
Attention is GQA, over the full sequence (the flash-attention kernel when
``cfg.use_flash`` asks for it) or one token against a KV cache; the MLP is
SwiGLU.  MLA, M-RoPE, cross attention, MoE and the gelu MLP come with later
parts of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(key: prng.Key, d_in: int, d_out: int, *, dtype,
               bias: bool = False, device: DeviceLike = None) -> Params:
    """The reference's draw: ``normal(key) * (1/sqrt(d_in))``, then the
    cast to ``dtype``."""
    device = resolve_device(device)
    w = prng.normal(key, (d_in, d_out), device=device)
    p = {"w": w.mul_(1.0 / math.sqrt(d_in)).to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(key: prng.Key, cfg: ModelConfig, d: int, *,
              device: DeviceLike = None) -> Params:
    """Draws nothing: ``key`` keeps the reference's signature."""
    dt, dev = dtype_of(cfg.param_dtype), resolve_device(device)
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
# Attention (GQA) with optional KV cache
# ---------------------------------------------------------------------------


def init_attention(key: prng.Key, cfg: ModelConfig, *,
                   device: DeviceLike = None) -> Params:
    """GQA; the key splits 6 ways as the reference's (whose MLA branch
    uses the last two)."""
    dt = dtype_of(cfg.param_dtype)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    ks = prng.split(key, 6)
    kw = dict(dtype=dt, device=device)
    b = cfg.attn_qkv_bias
    return {
        "wq": dense_init(ks[0], D, H * dh, bias=b, **kw),
        "wk": dense_init(ks[1], D, K * dh, bias=b, **kw),
        "wv": dense_init(ks[2], D, K * dh, bias=b, **kw),
        "wo": dense_init(ks[3], H * dh, D, **kw),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, *, device: DeviceLike = None) -> Params:
    """Fixed-size ring buffer.  For SWA the buffer is only ``window`` long.
    Slots not written yet hold position −1, which the mask refuses."""
    device = resolve_device(device)
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    K, dh = cfg.n_kv_heads, cfg.head_dim()
    return {
        "k": torch.zeros(batch, buf, K, dh, dtype=dtype, device=device),
        "v": torch.zeros(batch, buf, K, dh, dtype=dtype, device=device),
        "pos": torch.full((batch, buf), -1, dtype=torch.int32, device=device),
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
                      positions: torch.Tensor,
                      cache: Optional[Params] = None,
                      cache_index: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (output, updated cache).

    * full sequence: cache=None — causal attention over x (B,S,D), through
      the flash-attention kernel when ``cfg.use_flash`` is set, there is no
      sliding window and S > 1, as in the reference.
    * decode: cache given, x is (B,1,D), cache_index (an int32 scalar
      tensor) picks the write slot.  The cache's buffers are updated in
      place (the reference returns new buffers; the port saves their
      copies) and the cache is returned.
    """
    B, S, _ = x.shape
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    q = dense(p["wq"], x).reshape(B, S, H, dh)
    k = dense(p["wk"], x).reshape(B, S, Kh, dh)
    v = dense(p["wv"], x).reshape(B, S, Kh, dh)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)

    if cache is None:
        if cfg.use_flash and cfg.sliding_window == 0 and S > 1:
            out = kops.flash_attention(q, k, v, causal=True)
        else:
            mask = _causal_mask(positions, positions, cfg.sliding_window)
            out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
        return dense(p["wo"], out.reshape(B, S, H * dh)), None

    # --- cached decode (S == 1) ---
    slot = cache_index % cache["k"].shape[1]
    for name, rows in (("k", k), ("v", v), ("pos", positions)):
        _scatter_rows(cache[name], rows, slot)
    mask = _causal_mask(positions, cache["pos"], cfg.sliding_window)
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg.attn_logit_softcap)
    return dense(p["wo"], out.reshape(B, S, H * dh)), cache


def _scatter_rows(buf: torch.Tensor, x: torch.Tensor,
                  slot: torch.Tensor) -> None:
    """Write x (B,1,...) into buf (B,S,...) at the slot (a scalar tensor,
    the same for every batch row), in place, in buf's dtype.  Stands for
    the reference's ``_scatter_rows`` and ``_scatter_pos`` alike."""
    buf.index_copy_(1, slot.reshape(1).long(), x.to(buf.dtype))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(key: prng.Key, cfg: ModelConfig, *,
             device: DeviceLike = None) -> Params:
    """SwiGLU (every dense config but whisper's gelu, which comes with the
    audio family)."""
    dt = dtype_of(cfg.param_dtype)
    D, Fd = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 3)
    kw = dict(dtype=dt, device=device)
    return {
        "w_gate": dense_init(ks[0], D, Fd, **kw),
        "w_up": dense_init(ks[1], D, Fd, **kw),
        "w_down": dense_init(ks[2], Fd, D, **kw),
    }


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU."""
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x))
                 * dense(p["w_up"], x))
