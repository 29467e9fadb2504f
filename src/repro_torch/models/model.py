"""Model API: init, full-sequence forward and the LM loss (port of the
training part of ``repro/models/model.py`` for dense decoder-only LMs).

A batch is a dict with ``tokens`` (B,S) int and optionally ``positions``
(B,S) and ``loss_mask`` (B,S-1).  The reference's ``lax.scan`` over layers
and its rematerialisation are compile and memory devices, not numerics;
here the layers run in a plain Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def _check_ported(cfg: ModelConfig) -> None:
    missing = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.attention_type == "mla"),
        ("encoder", cfg.encoder is not None),
        ("vision", cfg.vision is not None),
        ("layer_pattern", cfg.layer_pattern is not None),
        (f"pos_type={cfg.pos_type}", cfg.pos_type not in ("rope", "none")),
        (f"mlp_type={cfg.mlp_type}", cfg.mlp_type != "swiglu"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
                device: DeviceLike = None) -> Params:
    """Random parameters from ``seed`` (an int, or a ``torch.Generator``
    whose device they are made on).  The draws differ from the
    reference's ``jax.random`` ones; to compare the two, copy the
    reference's parameters across with ``interop.params_from_numpy``."""
    _check_ported(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
    dt = L.dtype_of(cfg.param_dtype)
    embed = torch.randn(cfg.padded_vocab(), cfg.d_model, generator=gen,
                        device=gen.device) * 0.02
    p: Params = {
        "embed": embed.to(dt),
        "final_norm": L.init_norm(gen, cfg, cfg.d_model),
        "blocks": [T.init_block(gen, cfg, i) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        head = torch.randn(cfg.d_model, cfg.padded_vocab(), generator=gen,
                           device=gen.device) / (cfg.d_model ** 0.5)
        p["lm_head"] = head.to(dt)
    return p


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B,S,V), aux losses)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt) * cfg.emb_scale
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
    for i, blk in enumerate(params["blocks"]):
        x = T.block_forward(blk, x, cfg, i, positions=pos)
    x = L.norm_forward(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), {}


def _lm_head(params, x, cfg):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)) * cfg.logit_scale
    if cfg.padded_vocab() != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.  ``logsumexp − gather`` takes the place of
    the reference's one-hot contraction (same value, no (B,S,V) one-hot)."""
    logits, aux = forward(params, batch, cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    logits = logits[:, -S:, :]
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1, :].to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(tgt, dtype=torch.float32)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + sum(aux.values()) if aux else loss
    return total, dict(aux, ce_loss=loss)
