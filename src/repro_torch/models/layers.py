"""Core neural-net layers (port of the attention-family part of
``repro/models/layers.py``).

Functional, as the reference: ``init_*`` builds a parameter tree (nested
dicts of tensors) from a ``core/prng.py`` key, split and drawn as the
reference's ``jax.random`` key, and ``*_forward`` consumes it.  The weight layout is the
reference's — dense ``w`` is ``(d_in, d_out)`` and the product is
``x @ w`` — so reference parameters copy across with no transposes.
Attention is GQA, over the full sequence (the flash-attention kernel when
``cfg.use_flash`` asks for it) or one token against a KV cache, with RoPE
or Qwen2-VL's M-RoPE; cross attention over an encoder's keys and values;
or DeepSeek-V2's multi-head latent attention (MLA) against a latent cache.
The feed-forward is the SwiGLU or GELU MLP or the grouped-dispatch mixture
of experts.
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


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B,S,H,dh); pos3: (3,B,S) int, the
    temporal / height / width position ids.  ``sections`` partitions the
    dh/2 frequency slots: slot f takes its angle from row ``sel[f]``.  The
    reference's one-hot contraction selects exactly one term per slot, so
    an index gather gives the same values."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover dh/2 = "
                         f"{dh // 2}")
    inv = rope_freqs(dh, theta, x.device)                    # (dh/2,)
    ang = pos3[..., None].to(torch.float32) * inv            # (3,B,S,dh/2)
    sel = torch.repeat_interleave(                           # (dh/2,)
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device), output_size=dh // 2)
    ang = ang.gather(0, sel.expand(1, *ang.shape[1:]))[0]    # (B,S,dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype)], dim=-1)


def sinusoids(pos: torch.Tensor, d: int) -> torch.Tensor:
    """pos (N,) f32 -> (N, d) f32: sin of pos / 10000^(2i/d) in the first
    half, cos in the second.  The reference's f32 ``jnp.power`` is
    correctly rounded on the CPU and ``torch.pow`` in f32 is not always
    (4 of 512 denominators at d 1024 differ by an ulp, which moves the
    sines of large angles by far more), so the power of the f32 exponent
    is taken in f64 and rounded once; exponent, quotient, sine and cosine
    stay f32."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    denom = torch.pow(10000.0, (2 * dim / d).double()).to(torch.float32)
    ang = pos.to(torch.float32)[:, None] / denom[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(n_pos: int, d: int, device=None) -> torch.Tensor:
    """(n_pos, d) f32, the table of positions 0 .. n_pos - 1."""
    return sinusoids(torch.arange(n_pos, dtype=torch.float32, device=device),
                     d)


# ---------------------------------------------------------------------------
# Attention (GQA / cross) with optional KV cache
# ---------------------------------------------------------------------------


def init_attention(key: prng.Key, cfg: ModelConfig, *,
                   device: DeviceLike = None) -> Params:
    """GQA or MLA; the key splits 6 ways as the reference's.  MLA draws
    from ``ks[0..4]``, and with ``q_lora_rank`` set draws ``wq`` again from
    ``ks[0]`` at the low-rank width, as there."""
    dt = dtype_of(cfg.param_dtype)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    ks = prng.split(key, 6)
    kw = dict(dtype=dt, device=device)
    if cfg.attention_type == "mla":
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        dev = resolve_device(device)
        p = {
            "wq": dense_init(ks[0], D, H * qk_dim, **kw),
            "wkv_a": dense_init(ks[1], D, m.kv_lora_rank + m.qk_rope_head_dim,
                                **kw),
            "kv_norm": {"scale": torch.ones(m.kv_lora_rank, dtype=dt,
                                            device=dev)},
            "wkv_b": dense_init(ks[2], m.kv_lora_rank,
                                H * (m.qk_nope_head_dim + m.v_head_dim), **kw),
            "wo": dense_init(ks[3], H * m.v_head_dim, D, **kw),
        }
        if m.q_lora_rank:
            p["wq_a"] = dense_init(ks[4], D, m.q_lora_rank, **kw)
            p["q_norm"] = {"scale": torch.ones(m.q_lora_rank, dtype=dt,
                                               device=dev)}
            p["wq"] = dense_init(ks[0], m.q_lora_rank, H * qk_dim, **kw)
        return p
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
    Slots not written yet hold position −1, which the mask refuses.  MLA
    caches the normalised latent (``kv_lora_rank``) and the shared rope
    key of each position, ``max_len`` of them (no ring)."""
    device = resolve_device(device)
    if cfg.attention_type == "mla":
        m = cfg.mla
        return {
            "ckv": torch.zeros(batch, max_len, m.kv_lora_rank, dtype=dtype,
                               device=device),
            "kpe": torch.zeros(batch, max_len, m.qk_rope_head_dim,
                               dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
        }
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
                      cross_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                      mrope_pos: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (output, updated cache).

    * full sequence: cache=None — causal attention over x (B,S,D), through
      the flash-attention kernel when ``cfg.use_flash`` is set, there is no
      sliding window and S > 1, as in the reference.
    * decode: cache given, x is (B,1,D), cache_index (an int32 scalar
      tensor) picks the write slot.  The cache's buffers are updated in
      place (the reference returns new buffers; the port saves their
      copies) and the cache is returned.
    * cross: ``cross_kv`` = the encoder's (k, v), each (B,Te,K,dh); x
      attends to all of it (``_sdpa`` under an all-true mask, never
      flash) and the cache comes back untouched.

    Queries and keys turn by M-RoPE (``mrope_pos`` (3,B,S)) where
    ``pos_type`` is ``mrope``, by RoPE where it is ``rope``.  MLA configs
    go to ``_mla_forward``, which never reaches flash, as in the
    reference.
    """
    if cfg.attention_type == "mla":
        return _mla_forward(p, x, cfg, positions=positions, cache=cache,
                            cache_index=cache_index)
    B, S, _ = x.shape
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    q = dense(p["wq"], x).reshape(B, S, H, dh)
    if cross_kv is not None:
        k, v = cross_kv
        mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
        return dense(p["wo"], out.reshape(B, S, H * dh)), cache
    k = dense(p["wk"], x).reshape(B, S, Kh, dh)
    v = dense(p["wv"], x).reshape(B, S, Kh, dh)
    if cfg.pos_type == "mrope":
        sections = cfg.vision.mrope_sections
        q = apply_mrope(q, mrope_pos, cfg.rope_theta, sections)
        k = apply_mrope(k, mrope_pos, cfg.rope_theta, sections)
    elif cfg.pos_type == "rope":
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


def _mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, cache: Optional[Params] = None,
                 cache_index: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """DeepSeek-V2 multi-head latent attention.  The cache holds only the
    normalised latent and the shared rope key; decode writes them at
    ``cache_index`` itself (no ring), in place, and expands every cached
    position through ``wkv_b`` again, as the reference does."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope = cfg.n_heads, m.qk_nope_head_dim
    qk_dim = nope + m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = _rms(dense(p["wq_a"], x), p["q_norm"]["scale"], cfg.norm_eps)
        q = dense(p["wq"], cq).reshape(B, S, H, qk_dim)
    else:
        q = dense(p["wq"], x).reshape(B, S, H, qk_dim)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, positions, cfg.rope_theta)

    kv_a = dense(p["wkv_a"], x)
    ckv, kpe = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    ckv = _rms(ckv, p["kv_norm"]["scale"], cfg.norm_eps)
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        for name, rows in (("ckv", ckv), ("kpe", kpe), ("pos", positions)):
            _scatter_rows(cache[name], rows, cache_index)
        ckv, kpe, k_pos = cache["ckv"], cache["kpe"], cache["pos"]
    else:
        k_pos = positions

    kv = dense(p["wkv_b"], ckv.to(x.dtype))
    Sk = kv.shape[1]
    kv = kv.reshape(B, Sk, H, nope + m.v_head_dim)
    kn, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([kn, kpe[:, :, None, :].to(x.dtype).expand(
        B, Sk, H, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([qn, qr], dim=-1)
    mask = _causal_mask(positions, k_pos, 0)
    out = _sdpa(q_full, k, v, mask, cfg.attn_logit_softcap)
    return dense(p["wo"], out.reshape(B, S, H * m.v_head_dim)), cache


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(key: prng.Key, cfg: ModelConfig, d_ff: Optional[int] = None,
             *, device: DeviceLike = None) -> Params:
    """SwiGLU, or where ``mlp_type`` is ``gelu`` (whisper) an up and a
    down projection with biases drawn from ``ks[0]`` and ``ks[1]``, as the
    reference's; of width ``d_ff or cfg.d_ff``: the shared experts and the
    dense layers below ``first_k_dense`` pass their own."""
    dt = dtype_of(cfg.param_dtype)
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    ks = prng.split(key, 3)
    kw = dict(dtype=dt, device=device)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(ks[0], D, Fd, **kw),
            "w_up": dense_init(ks[1], D, Fd, **kw),
            "w_down": dense_init(ks[2], Fd, D, **kw),
        }
    return {
        "w_up": dense_init(ks[0], D, Fd, bias=True, **kw),
        "w_down": dense_init(ks[1], Fd, D, bias=True, **kw),
    }


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, or GELU in ``jax.nn.gelu``'s default form, the tanh
    approximation."""
    if "w_gate" in p:
        return dense(p["w_down"], F.silu(dense(p["w_gate"], x))
                     * dense(p["w_up"], x))
    return dense(p["w_down"], F.gelu(dense(p["w_up"], x), approximate="tanh"))


# ---------------------------------------------------------------------------
# Mixture of experts (GShard-style grouped capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(key: prng.Key, cfg: ModelConfig, *,
             device: DeviceLike = None) -> Params:
    """The reference's draws: the key splits 5 ways; the router (D, E) in
    f32 from ``ks[0]``; the experts' (E, D, F) gate and up and (E, F, D)
    down from ``ks[1..3]``; the shared experts, one SwiGLU of width
    ``F · n_shared_experts``, from ``ks[4]``."""
    m = cfg.moe
    dt, dev = dtype_of(cfg.param_dtype), resolve_device(device)
    D, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    ks = prng.split(key, 5)
    s = 1.0 / math.sqrt(D)
    p = {
        "router": prng.normal(ks[0], (D, E), device=dev).mul_(s),
        "w_gate": prng.normal(ks[1], (E, D, Fe), device=dev).mul_(s).to(dt),
        "w_up": prng.normal(ks[2], (E, D, Fe), device=dev).mul_(s).to(dt),
        "w_down": prng.normal(ks[3], (E, Fe, D), device=dev).div_(
            math.sqrt(Fe)).to(dt),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(ks[4], cfg, d_ff=Fe * m.n_shared_experts,
                               device=dev)
    return p


def moe_route(p: Params, x: torch.Tensor, cfg: ModelConfig,
              group_size: int = 256) -> Dict[str, Any]:
    """The router of ``moe_forward``: x (B,S,D) viewed as G groups of Sg
    tokens (Sg = min(group_size, T) halved until it divides T), each
    expert's capacity C = min(max(4, int(Sg·k/E·cf)), Sg), as the
    reference's; softmax over the experts in f32; the top k by a stable
    descending sort, so that ties go to the lower expert index as
    ``jax.lax.top_k`` breaks them; the k probabilities renormalised.  Each
    (token, slot) takes its place in its expert's queue from a cumulative
    count over the flattened (Sg·k) order, token-major and slot-minor, and
    is dropped at place C or later."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    Sg = min(group_size, T)
    while T % Sg:
        Sg //= 2
    G = T // Sg
    C = min(max(4, int(Sg * m.top_k / m.n_experts * m.capacity_factor)), Sg)
    logits = x.reshape(G, Sg, D).to(torch.float32) @ p["router"]  # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :m.top_k], idx[..., :m.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx, m.n_experts)                     # (G,Sg,k,E)
    flat = onehot.reshape(G, Sg * m.top_k, m.n_experts)
    place = (torch.cumsum(flat, dim=1) * flat).sum(-1) - 1        # (G,Sg·k)
    place = place.reshape(G, Sg, m.top_k)
    return {"G": G, "Sg": Sg, "C": C, "logits": logits, "probs": probs,
            "gate_vals": gate_vals, "gate_idx": gate_idx, "onehot": onehot,
            "place": place, "keep": place < C}


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                group_size: int = 256
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,D) -> (out, aux losses), the reference's grouped capacity
    dispatch (``moe_route``).  Its one-hot (G,Sg,E,C) dispatch and combine
    contractions become an index copy into the (E, G·C, D) expert buffer
    and a gather from it: each one-hot row holds one term, so no value
    changes.  The expert buffer and its three batched products stay, as
    the reference's arithmetic (plain matmuls: the reference leaves them
    to XLA).  The combine weights are rounded to x's dtype before they
    multiply the expert outputs, as there; a dropped slot weighs 0.  aux:
    the Switch load balance (from the counts before drops) and the router
    z-loss, each times its coefficient."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    r = moe_route(p, x, cfg, group_size)
    G, Sg, C, keep = r["G"], r["Sg"], r["C"], r["keep"]
    # a slot's row in the (E·G·C) buffer; dropped slots go to one spare row
    g_ix = torch.arange(G, device=x.device).reshape(G, 1, 1)
    row = (r["gate_idx"] * G + g_ix) * C + r["place"]
    row = torch.where(keep, row, E * G * C).reshape(-1)
    src = x.reshape(G, Sg, 1, D).expand(G, Sg, k, D).reshape(-1, D)
    ex_in = torch.index_copy(x.new_zeros(E * G * C + 1, D), 0, row, src)
    ex_in = ex_in[:-1].reshape(E, G * C, D)
    h = (F.silu(torch.bmm(ex_in, p["w_gate"].to(x.dtype)))
         * torch.bmm(ex_in, p["w_up"].to(x.dtype)))
    ex_out = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(E * G * C, D)
    picked = ex_out[torch.clamp(row, max=E * G * C - 1)]           # (T·k, D)
    w = (r["gate_vals"].to(x.dtype) * keep.to(x.dtype)).reshape(-1, 1)
    out = (w.to(torch.float32) * picked.to(torch.float32)).reshape(
        G, Sg, k, D).sum(2).to(x.dtype).reshape(B, S, D)

    frac_tokens = r["onehot"].sum(2).to(torch.float32).mean(dim=(0, 1))
    frac_probs = r["probs"].mean(dim=(0, 1))
    lb = E * (frac_tokens * frac_probs).sum()
    z = torch.logsumexp(r["logits"], dim=-1).square().mean()
    aux = {"moe_load_balance": m.router_aux_coef * lb,
           "moe_z_loss": m.router_z_coef * z}
    if "shared" in p:
        out = out + mlp_forward(p["shared"], x, cfg)
    return out, aux
