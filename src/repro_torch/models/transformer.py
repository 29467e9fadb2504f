"""Block composition (port of the attention-block part of
``repro/models/transformer.py``): a pre-norm attention sublayer (GQA or
MLA) and a feed-forward sublayer (SwiGLU MLP or mixture of experts), over
the full sequence or one token against the block's cache.  Mamba and
xLSTM blocks come with their families."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _check_attention_block(cfg: ModelConfig, layer_idx: int) -> None:
    if cfg.block_kind(layer_idx) != "attn":
        raise NotImplementedError(
            f"layer {layer_idx}: {cfg.block_kind(layer_idx)} blocks are not "
            f"ported yet")


def _has_ffn(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


def init_block(key: prng.Key, cfg: ModelConfig, layer_idx: int, *,
               device: DeviceLike = None) -> Params:
    """The key splits 4 ways as the reference's: norm1, the mixer, norm2,
    the feed-forward: experts where ``layer_uses_moe``, else an MLP of
    width ``d_ff_dense or d_ff`` below ``first_k_dense`` and ``d_ff``
    above."""
    _check_attention_block(cfg, layer_idx)
    ks = prng.split(key, 4)
    p: Params = {"norm1": L.init_norm(ks[0], cfg, cfg.d_model, device=device),
                 "attn": L.init_attention(ks[1], cfg, device=device)}
    if _has_ffn(cfg, layer_idx):
        p["norm2"] = L.init_norm(ks[2], cfg, cfg.d_model, device=device)
        m = cfg.moe
        if cfg.layer_uses_moe(layer_idx):
            p["moe"] = L.init_moe(ks[3], cfg, device=device)
        else:
            d_ff = ((m.d_ff_dense or cfg.d_ff)
                    if m and layer_idx < m.first_k_dense else cfg.d_ff)
            p["mlp"] = L.init_mlp(ks[3], cfg, d_ff=d_ff, device=device)
    return p


def init_block_cache(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, dtype=torch.bfloat16, *,
                     device: DeviceLike = None) -> Params:
    """The attention's cache: GQA's ring buffer or MLA's latent cache."""
    _check_attention_block(cfg, layer_idx)
    return L.init_kv_cache(cfg, batch, max_len, dtype, device=device)


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                  *, positions: torch.Tensor,
                  cache: Optional[Params] = None,
                  cache_index: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             Optional[Params]]:
    """Returns (x, the feed-forward's aux losses — empty but for MoE —,
    the block's updated cache — None without a cache)."""
    h = L.norm_forward(p["norm1"], x, cfg)
    h, new_cache = L.attention_forward(p["attn"], h, cfg, positions=positions,
                                       cache=cache, cache_index=cache_index)
    x = x + h * cfg.residual_scale
    aux: Dict[str, torch.Tensor] = {}
    if "norm2" in p:
        h = L.norm_forward(p["norm2"], x, cfg)
        if "moe" in p:
            h, aux = L.moe_forward(p["moe"], h, cfg)
        else:
            h = L.mlp_forward(p["mlp"], h, cfg)
        x = x + h * cfg.residual_scale
    return x, aux, new_cache
