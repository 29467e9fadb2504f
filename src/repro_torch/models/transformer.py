"""Block composition (port of the attention-block part of
``repro/models/transformer.py``): pre-norm attention + MLP sublayers."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int) -> Params:
    kind = cfg.block_kind(layer_idx)
    if kind != "attn" or cfg.layer_uses_moe(layer_idx):
        raise NotImplementedError(
            f"layer {layer_idx}: only dense attention blocks are ported")
    p: Params = {"norm1": L.init_norm(gen, cfg, cfg.d_model),
                 "attn": L.init_attention(gen, cfg)}
    if cfg.d_ff > 0:
        p["norm2"] = L.init_norm(gen, cfg, cfg.d_model)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                  *, positions: torch.Tensor) -> torch.Tensor:
    h = L.norm_forward(p["norm1"], x, cfg)
    h = L.attention_forward(p["attn"], h, cfg, positions=positions)
    x = x + h * cfg.residual_scale
    if "norm2" in p:
        h = L.norm_forward(p["norm2"], x, cfg)
        x = x + L.mlp_forward(p["mlp"], h, cfg) * cfg.residual_scale
    return x
