"""Block composition (port of the attention-block part of
``repro/models/transformer.py``): pre-norm attention + MLP sublayers, over
the full sequence or one token against the block's KV cache."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _check_attention_block(cfg: ModelConfig, layer_idx: int) -> None:
    if cfg.block_kind(layer_idx) != "attn" or cfg.layer_uses_moe(layer_idx):
        raise NotImplementedError(
            f"layer {layer_idx}: only dense attention blocks are ported")


def init_block(key: prng.Key, cfg: ModelConfig, layer_idx: int, *,
               device: DeviceLike = None) -> Params:
    """The key splits 4 ways as the reference's: norm1, the mixer, norm2,
    the feed-forward."""
    _check_attention_block(cfg, layer_idx)
    ks = prng.split(key, 4)
    p: Params = {"norm1": L.init_norm(ks[0], cfg, cfg.d_model, device=device),
                 "attn": L.init_attention(ks[1], cfg, device=device)}
    if cfg.d_ff > 0:
        p["norm2"] = L.init_norm(ks[2], cfg, cfg.d_model, device=device)
        p["mlp"] = L.init_mlp(ks[3], cfg, device=device)
    return p


def init_block_cache(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, dtype=torch.bfloat16, *,
                     device: DeviceLike = None) -> Params:
    _check_attention_block(cfg, layer_idx)
    return L.init_kv_cache(cfg, batch, max_len, dtype, device=device)


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                  *, positions: torch.Tensor,
                  cache: Optional[Params] = None,
                  cache_index: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (x, the block's updated cache — None without a cache)."""
    h = L.norm_forward(p["norm1"], x, cfg)
    h, new_cache = L.attention_forward(p["attn"], h, cfg, positions=positions,
                                       cache=cache, cache_index=cache_index)
    x = x + h * cfg.residual_scale
    if "norm2" in p:
        h = L.norm_forward(p["norm2"], x, cfg)
        x = x + L.mlp_forward(p["mlp"], h, cfg) * cfg.residual_scale
    return x, new_cache
