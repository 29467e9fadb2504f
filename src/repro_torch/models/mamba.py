"""Mamba (selective SSM) block of the Jamba hybrid (port of
``repro/models/mamba.py``).

The full sequence runs the recurrence h_t = g_t * h_{t-1} + u_t as a
log-depth associative scan (``associative_scan``: jax's own odd / even
recursion, so every product and sum happens in the reference's order);
decode updates an explicit recurrent state (the last ``d_conv - 1``
inputs of the causal convolution and the (Di, N) SSM state), returned as
new tensors.  Reference: Gu & Dao 2023; Jamba (arXiv:2403.19887)
interleaves this block with attention at a 1:7 ratio.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]


def _dt_rank(cfg: ModelConfig) -> int:
    m = cfg.mamba
    return m.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` in its op order:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba(key: prng.Key, cfg: ModelConfig, *,
               device: DeviceLike = None) -> Params:
    """The reference's draws: the key splits 7 ways (``ks[6]`` unused);
    ``dt_proj_b`` = log(expm1(clip(0.099·U + 0.001, 1e-4))) from
    ``ks[4]``; S4D-real ``A_log`` = log(1..N) and ``D`` = 1 stay f32
    whatever ``param_dtype`` is, as there."""
    m: MambaConfig = cfg.mamba
    dt, dev = dtype_of(cfg.param_dtype), resolve_device(device)
    D, Di, R, N = cfg.d_model, d_inner(cfg), _dt_rank(cfg), m.d_state
    ks = prng.split(key, 7)
    s = 1.0 / math.sqrt(D)
    u = prng.uniform(ks[4], (Di,), device=dev) * 0.099 + 0.001
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)
    return {
        "in_proj": prng.normal(ks[0], (D, 2 * Di), device=dev).mul_(s).to(dt),
        "conv_w": prng.normal(ks[1], (m.d_conv, Di), device=dev).div_(
            math.sqrt(m.d_conv)).to(dt),
        "conv_b": torch.zeros(Di, dtype=dt, device=dev),
        "x_proj": prng.normal(ks[2], (Di, R + 2 * N), device=dev).div_(
            math.sqrt(Di)).to(dt),
        "dt_proj_w": prng.normal(ks[3], (R, Di), device=dev).div_(
            math.sqrt(R)).to(dt),
        "dt_proj_b": torch.log(torch.expm1(torch.clamp_min(u, 1e-4))).to(dt),
        "A_log": torch.log(A),
        "D": torch.ones(Di, dtype=torch.float32, device=dev),
        "out_proj": prng.normal(ks[5], (Di, D), device=dev).div_(
            math.sqrt(Di)).to(dt),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: DeviceLike = None) -> Params:
    Di, N, Kc = d_inner(cfg), cfg.mamba.d_state, cfg.mamba.d_conv
    device = resolve_device(device)
    return {
        "ssm": torch.zeros(batch, Di, N, dtype=dtype, device=device),
        "conv": torch.zeros(batch, Kc - 1, Di, dtype=dtype, device=device),
    }


def _ssm_params(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,Di) -> (dt, B_mat, C_mat) selective parameters: the
    projections and the softplus in x's dtype, then each cast to f32."""
    R, N = _dt_rank(cfg), cfg.mamba.d_state
    proj = x @ p["x_proj"].to(x.dtype)                        # (B,S,R+2N)
    dt_r, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = softplus(dt_r @ p["dt_proj_w"].to(x.dtype)
                  + p["dt_proj_b"].to(x.dtype))               # (B,S,Di)
    return dt.float(), Bm.float(), Cm.float()


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[:, 0], b[:, 0], a[:, 1], ... along dim 1; a is as long as b or
    one longer (jax's ``_interleave``, which pads and adds zeros: the same
    values)."""
    n = b.shape[1]
    out = torch.stack((a[:, :n], b), dim=2).flatten(1, 2)
    return out if a.shape[1] == n else torch.cat((out, a[:, n:]), dim=1)


def associative_scan(g: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the combine (g1, u1), (g2, u2) ->
    (g2·g1, g2·u1 + u2) (the reference's ``_scan_combine``), by the
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half, fill the even positions from the odd results (an odd
    length combines every odd result, an even one all but the last), and
    keep the first element as it is."""
    n = g.shape[1]
    if n < 2:
        return g, u
    g1, u1, g2, u2 = g[:, 0:-1:2], u[:, 0:-1:2], g[:, 1::2], u[:, 1::2]
    odd_g, odd_u = associative_scan(g2 * g1, g2 * u1 + u2)
    if n % 2 == 0:
        prev_g, prev_u = odd_g[:, :-1], odd_u[:, :-1]
    else:
        prev_g, prev_u = odd_g, odd_u
    g3, u3 = g[:, 2::2], u[:, 2::2]
    even_g = torch.cat((g[:, :1], g3 * prev_g), dim=1)
    even_u = torch.cat((u[:, :1], g3 * prev_u + u3), dim=1)
    return _interleave(even_g, odd_g), _interleave(even_u, odd_u)


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Params] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  Full sequence if state is None (returns no state),
    else one-token decode (S == 1) returning the new state in the old
    state's dtypes: the conv state is read in x's dtype and written back
    in its own, as in the reference."""
    m: MambaConfig = cfg.mamba
    B, S, _ = x.shape
    Di, Kc = d_inner(cfg), m.d_conv
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = torch.split(xz, Di, dim=-1)                       # (B,S,Di) each

    if state is None:
        # depthwise causal conv by padding
        pad = xs.new_zeros(B, Kc - 1, Di)
        xp = torch.cat((pad, xs), dim=1)                      # (B,S+Kc-1,Di)
        conv = sum(xp[:, i:i + S, :] * p["conv_w"][i].to(xs.dtype)
                   for i in range(Kc)) + p["conv_b"].to(xs.dtype)
        new_conv_state = None
    else:
        xp = torch.cat((state["conv"].to(xs.dtype), xs), dim=1)  # (B,Kc,Di)
        conv = torch.einsum("bkd,kd->bd", xp,
                            p["conv_w"].to(xs.dtype))[:, None, :] \
            + p["conv_b"].to(xs.dtype)
        new_conv_state = xp[:, 1:, :]
    u = F.silu(conv)

    dt, Bm, Cm = _ssm_params(p, u, cfg)
    A = -torch.exp(p["A_log"])                                # (Di,N)
    uf = u.float()
    # discretize: g = exp(dt*A), inp = dt * B * x (ZOH on B, approximated
    # by Euler)
    g = torch.exp(dt[..., None] * A)                          # (B,S,Di,N)
    inp = (dt * uf)[..., None] * Bm[:, :, None, :]            # (B,S,Di,N)

    if state is None:
        _, h = associative_scan(g, inp)
        new_ssm = None
    else:
        h = g[:, 0] * state["ssm"].float() + inp[:, 0]
        new_ssm = h
        h = h[:, None]                                        # (B,1,Di,N)
    del g, inp
    y = torch.einsum("bsdn,bsn->bsd", h, Cm) + p["D"] * uf    # (B,S,Di)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    if state is None:
        return out, None
    return out, {"ssm": new_ssm.to(state["ssm"].dtype),
                 "conv": new_conv_state.to(state["conv"].dtype)}
