"""xLSTM blocks (port of ``repro/models/xlstm.py``; arXiv:2405.04517):
mLSTM (matrix memory, parallelisable) and sLSTM (scalar memory, strictly
recurrent).

The mLSTM runs the full sequence in chunkwise-parallel form: the sequence
is cut into chunks, and a Python loop over them (the reference's
``lax.scan``) carries the stabilised matrix state (C, n, m) from chunk to
chunk while each chunk computes its quadratic part locally.  The sLSTM
runs a loop over time steps, carried in f32.  Decode takes one step of
each recurrence and returns the new state as new tensors.

Stabilisation follows the paper: with a_t = Σ_{r≤t} log f_r and
b_s = log i_s − a_s, the output weights are exp(b_s − μ_t) with
μ_t = max(m_state, cummax_{s≤t} b_s); the carried state is C·e^{−m}.
The initial m of both recurrences is −1e30 in f32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dtype_of
from repro_torch.models.mamba import softplus

Params = Dict[str, Any]

CHUNK = 256
CONV_K = 4
M_INIT = -1e30


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: −softplus(−x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM block (pre-up-projection, factor 2)
# ---------------------------------------------------------------------------


def init_mlstm(key: prng.Key, cfg: ModelConfig, *,
               device: DeviceLike = None) -> Params:
    """The reference's draws: the key splits 8 ways (``ks[7]`` unused);
    the forget-gate bias starts at 3.0."""
    dt, dev = dtype_of(cfg.param_dtype), resolve_device(device)
    D = cfg.d_model
    Di = 2 * D
    H = cfg.n_heads
    ks = prng.split(key, 8)
    s = 1.0 / math.sqrt(D)
    si = 1.0 / math.sqrt(Di)

    def normal(k, shape, scale):
        return prng.normal(k, shape, device=dev).mul_(scale).to(dt)
    return {
        "up": normal(ks[0], (D, 2 * Di), s),
        "conv_w": prng.normal(ks[1], (CONV_K, Di), device=dev).div_(
            math.sqrt(CONV_K)).to(dt),
        "conv_b": torch.zeros(Di, dtype=dt, device=dev),
        "wq": normal(ks[2], (Di, Di), si),
        "wk": normal(ks[3], (Di, Di), si),
        "wv": normal(ks[4], (Di, Di), si),
        "w_if": normal(ks[5], (Di, 2 * H), si),
        "b_i": torch.zeros(H, dtype=dt, device=dev),
        "b_f": torch.full((H,), 3.0, dtype=dt, device=dev),
        "ogate_norm": torch.ones(Di, dtype=dt, device=dev),
        "down": normal(ks[6], (Di, D), si),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: DeviceLike = None) -> Params:
    H = cfg.n_heads
    dh = (2 * cfg.d_model) // H
    Di = 2 * cfg.d_model
    device = resolve_device(device)
    return {
        "C": torch.zeros(batch, H, dh, dh, dtype=dtype, device=device),
        "n": torch.zeros(batch, H, dh, dtype=dtype, device=device),
        "m": torch.full((batch, H), M_INIT, dtype=dtype, device=device),
        "conv": torch.zeros(batch, CONV_K - 1, Di, dtype=dtype,
                            device=device),
    }


def _headify(x: torch.Tensor, H: int) -> torch.Tensor:
    B, S, Di = x.shape
    return x.reshape(B, S, H, Di // H)


def _group_norm(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head normalisation of (B,S,H,dh), in f32, returned (B,S,H·dh)
    in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    B, S, H, dh = x.shape
    return (y.reshape(B, S, H * dh) * scale.float()).to(x.dtype)


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Params] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  Full sequence (chunkwise) if state is None, else one
    decode step (S == 1) returning the new state; the conv state is read
    in x's dtype and written back in its own."""
    B, S, D = x.shape
    H = cfg.n_heads
    Di = 2 * D
    dh = Di // H
    up = x @ p["up"].to(x.dtype)
    xi, z = torch.split(up, Di, dim=-1)                      # (B,S,Di) each

    # causal depthwise conv on the qk path
    if state is None:
        xp = torch.cat((xi.new_zeros(B, CONV_K - 1, Di), xi), dim=1)
        new_conv = None
    else:
        xp = torch.cat((state["conv"].to(xi.dtype), xi), dim=1)
        new_conv = xp[:, 1:, :]
    conv = sum(xp[:, i:i + S, :] * p["conv_w"][i].to(xi.dtype)
               for i in range(CONV_K)) + p["conv_b"].to(xi.dtype)
    cx = F.silu(conv)

    q = _headify(cx @ p["wq"].to(x.dtype), H) / math.sqrt(dh)
    k = _headify(cx @ p["wk"].to(x.dtype), H)
    v = _headify(xi @ p["wv"].to(x.dtype), H)
    gates = (cx @ p["w_if"].to(x.dtype)).float()
    log_i = gates[..., :H] + p["b_i"].float()                 # (B,S,H)
    log_f = log_sigmoid(gates[..., H:] + p["b_f"].float())

    if state is not None:
        h, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                   log_i[:, 0], log_f[:, 0], state)
        h = h[:, None]                                        # (B,1,H,dh)
        new_state["conv"] = new_conv.to(state["conv"].dtype)
    else:
        h = _mlstm_chunkwise(q, k, v, log_i, log_f)
        new_state = None

    h = _group_norm(h, p["ogate_norm"]) * F.silu(z)
    out = h @ p["down"].to(x.dtype)
    return out, new_state


def _mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step.  q,k,v: (B,H,dh); log_i/f: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    fs = torch.exp(log_f + m - m_new)[..., None]
    is_ = torch.exp(log_i - m_new)[..., None]
    C_new = fs[..., None] * C + is_[..., None] * (k[..., :, None]
                                                  * v[..., None, :])
    n_new = fs * n + is_ * k
    num = torch.einsum("bhd,bhde->bhe", q.float(), C_new)
    den = torch.einsum("bhd,bhd->bh", q.float(), n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_chunk(carry, qj, kj, vj, li, lf):
    """One chunk of ``_mlstm_chunkwise``: (C, n, m) (B,H,dh,dh), (B,H,dh),
    (B,H) and the chunk's (B,L,...) inputs -> (the new carry, h
    (B,L,H,dh))."""
    C, n, m = carry
    L = qj.shape[1]
    a = torch.cumsum(lf, dim=1)                               # (B,L,H)
    b = li - a
    bmax = torch.cummax(b, dim=1).values
    mu = torch.maximum(m[:, None], bmax)                      # (B,L,H)
    # intra-chunk quadratic part
    wloc = torch.exp(b[:, None, :, :] - mu[:, :, None, :])    # (B,Lq,Ls,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=qj.device))
    wloc = torch.where(causal[None, :, :, None], wloc, 0.0)
    scores = torch.einsum("bqhd,bshd->bqsh", qj, kj) * wloc
    num = torch.einsum("bqsh,bshd->bqhd", scores, vj)
    den = scores.sum(dim=2)                                   # (B,L,H)
    # inter-chunk contribution from the carried state
    wstate = torch.exp(m[:, None] - mu)                       # (B,L,H)
    num = num + wstate[..., None] * torch.einsum("blhd,bhde->blhe", qj, C)
    den = den + wstate * torch.einsum("blhd,bhd->blh", qj, n)
    # the true max exponent at step l is a_l + mu_l (a cancels in the
    # weights but not in the |den| >= exp(-m) stabiliser clamp)
    hj = num / torch.maximum(den.abs(), torch.exp(-(a + mu)))[..., None]
    # advance the state to the end of the chunk
    A = a[:, -1]                                              # (B,H)
    m_end = torch.maximum(m + A, A + bmax[:, -1])
    w_in = torch.exp(A[:, None] + b - m_end[:, None])         # (B,L,H)
    decay = torch.exp(m + A - m_end)
    C_new = decay[..., None, None] * C + torch.einsum(
        "blh,blhd,blhe->bhde", w_in, kj, vj)
    n_new = decay[..., None] * n + torch.einsum("blh,blhd->bhd", w_in, kj)
    return (C_new, n_new, m_end), hj


def _mlstm_chunkwise(q, k, v, log_i, log_f):
    """q,k,v: (B,S,H,dh); log_i, log_f: (B,S,H).  Returns h (B,S,H,dh) in
    q's dtype.  Chunks of L = min(CHUNK, S), halved until L divides S."""
    B, S, H, dh = q.shape
    L = min(CHUNK, S)
    while S % L:
        L //= 2
    f32 = torch.float32
    carry = (q.new_zeros(B, H, dh, dh, dtype=f32),
             q.new_zeros(B, H, dh, dtype=f32),
             q.new_full((B, H), M_INIT, dtype=f32))
    hs = []
    for j in range(0, S, L):
        carry, hj = _mlstm_chunk(
            carry, q[:, j:j + L].float(), k[:, j:j + L].float(),
            v[:, j:j + L].float(), log_i[:, j:j + L], log_f[:, j:j + L])
        hs.append(hj)
    return torch.cat(hs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# sLSTM block (post-up-projection), strictly recurrent
# ---------------------------------------------------------------------------


def init_slstm(key: prng.Key, cfg: ModelConfig, *,
               device: DeviceLike = None) -> Params:
    """The reference's draws: the key splits 6 ways (``ks[5]`` unused);
    the bias is [0, 3, 0, 0] blocks (input, forget, cell, output gates);
    the feed-forward is ``int(D·4/3/64)·64`` wide when ``d_ff`` is 0."""
    dt, dev = dtype_of(cfg.param_dtype), resolve_device(device)
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    ks = prng.split(key, 6)
    s = 1.0 / math.sqrt(D)
    ff = max(1, int(D * 4 / 3 / 64) * 64) if cfg.d_ff == 0 else cfg.d_ff
    b = torch.zeros(4 * D, dtype=torch.float32, device=dev)
    b[D:2 * D] = 3.0
    return {
        "wx": prng.normal(ks[0], (D, 4 * D), device=dev).mul_(s).to(dt),
        "r": prng.normal(ks[1], (H, dh, 4 * dh), device=dev).div_(
            math.sqrt(dh)).to(dt),
        "b": b.to(dt),
        "gn": torch.ones(D, dtype=dt, device=dev),
        "ff_gate": prng.normal(ks[2], (D, ff), device=dev).mul_(s).to(dt),
        "ff_up": prng.normal(ks[3], (D, ff), device=dev).mul_(s).to(dt),
        "ff_down": prng.normal(ks[4], (ff, D), device=dev).div_(
            math.sqrt(ff)).to(dt),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: DeviceLike = None) -> Params:
    D = cfg.d_model
    device = resolve_device(device)
    return {
        "c": torch.zeros(batch, D, dtype=dtype, device=device),
        "n": torch.zeros(batch, D, dtype=dtype, device=device),
        "h": torch.zeros(batch, D, dtype=dtype, device=device),
        "m": torch.full((batch, D), M_INIT, dtype=dtype, device=device),
    }


def _slstm_cell(p: Params, xt: torch.Tensor, st: Params,
                cfg: ModelConfig) -> Params:
    """xt: (B,4D) the input's pre-computed contribution; st: the f32
    state.  Returns the next state."""
    H = cfg.n_heads
    D = cfg.d_model
    dh = D // H
    B = xt.shape[0]
    hprev = st["h"].reshape(B, H, dh)
    rec = torch.einsum("bhd,hde->bhe", hprev.float(),
                       p["r"].float()).reshape(B, 4 * D)
    pre = xt.float() + rec + p["b"].float()
    li_, lf_, z_, o_ = torch.split(pre, D, dim=-1)
    log_i = li_                                    # exponential input gate
    log_f = log_sigmoid(lf_)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    m_new = torch.maximum(log_f + st["m"], log_i)
    fs = torch.exp(log_f + st["m"] - m_new)
    is_ = torch.exp(log_i - m_new)
    c_new = fs * st["c"] + is_ * z
    n_new = fs * st["n"] + is_
    # torch.maximum's gradient splits evenly at a tie, as jnp.maximum's
    # does (clamp_min's does not): the first step gives n = 1 exactly
    h_new = o * c_new / torch.maximum(n_new, n_new.new_ones(()))
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Params] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  Full sequence (a loop over the time steps from the
    initial state) if state is None, else one decode step returning the
    new state in the old state's dtypes."""
    B, S, D = x.shape
    xg = x @ p["wx"].to(x.dtype)                              # (B,S,4D)

    if state is not None:
        st = {k: v.float() for k, v in state.items()}
        st = _slstm_cell(p, xg[:, 0], st, cfg)
        h = st["h"][:, None]
        new_state = {k: v.to(state[k].dtype) for k, v in st.items()}
    else:
        st = init_slstm_state(cfg, B, device=x.device)
        hs = []
        for t in range(S):
            st = _slstm_cell(p, xg[:, t], st, cfg)
            hs.append(st["h"])
        h = torch.stack(hs, dim=1)                            # (B,S,D)
        new_state = None

    h = _group_norm(h.reshape(B, -1, cfg.n_heads, D // cfg.n_heads),
                    p["gn"]).to(x.dtype)
    # gated feed-forward (post-up-projection block)
    y = (F.silu(h @ p["ff_gate"].to(x.dtype))
         * (h @ p["ff_up"].to(x.dtype))) @ p["ff_down"].to(x.dtype)
    return y, new_state
