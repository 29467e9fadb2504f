"""Model API: init, full-sequence forward (train / prefill), single-token
decode against caches, and the LM loss (port of ``repro/models/model.py``
for decoder-only LMs: dense, MoE and MLA).

A batch is a dict with ``tokens`` (B,S) int and optionally ``positions``
(B,S) and ``loss_mask`` (B,S-1); for decode steps it carries a single
token column (B,1).  The reference's ``lax.scan`` over layers and its
rematerialisation are compile and memory devices, not numerics; here the
layers run in a plain Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def _check_ported(cfg: ModelConfig) -> None:
    missing = [name for name, on in (
        ("encoder", cfg.encoder is not None),
        ("vision", cfg.vision is not None),
        ("layer_pattern", cfg.layer_pattern is not None),
        (f"pos_type={cfg.pos_type}", cfg.pos_type not in ("rope", "none")),
        (f"mlp_type={cfg.mlp_type}", cfg.mlp_type != "swiglu"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def init_params(seed: int, cfg: ModelConfig, *,
                device: DeviceLike = None) -> Params:
    """Random parameters from ``seed``, the reference's
    ``init_params(jax.random.PRNGKey(seed), cfg)``: the same key splits
    and ``jax.random.normal`` draws (``core/prng.py``, a few ulps), each
    scaled and then cast to ``param_dtype`` as there."""
    _check_ported(cfg)
    device = resolve_device(device)
    dt = L.dtype_of(cfg.param_dtype)
    ks = prng.split(prng.prng_key(seed), cfg.n_layers + 4)
    embed = prng.normal(ks[0], (cfg.padded_vocab(), cfg.d_model),
                        device=device)
    p: Params = {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": L.init_norm(ks[1], cfg, cfg.d_model, device=device),
        "blocks": [T.init_block(ks[2 + i], cfg, i, device=device)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        head = prng.normal(ks[-2], (cfg.d_model, cfg.padded_vocab()),
                           device=device)
        p["lm_head"] = head.div_(cfg.d_model ** 0.5).to(dt)
    return p


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device: DeviceLike = None) -> Params:
    """One KV cache per layer and the decode index (an int32 scalar tensor
    on the caches' device)."""
    _check_ported(cfg)
    device = resolve_device(device)
    return {
        "layers": [T.init_block_cache(cfg, i, batch, max_len, dtype,
                                      device=device)
                   for i in range(cfg.n_layers)],
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def active_param_count(cfg: ModelConfig, params: Params) -> int:
    """MoE-aware, as the reference's: of each MoE layer's experts only
    top_k count per token (the router and shared experts always do)."""
    total = param_count(params)
    m = cfg.moe
    if m is None:
        return total
    inactive = 0
    for blk in params["blocks"]:
        if "moe" in blk:
            per_expert = sum(blk["moe"][k].numel() // m.n_experts
                             for k in ("w_gate", "w_up", "w_down"))
            inactive += per_expert * (m.n_experts - m.top_k)
    return total - inactive


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B,S,V), aux losses: each
    MoE layer's summed over the layers, in layer order)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt) * cfg.emb_scale
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
    aux_total: Dict[str, torch.Tensor] = {}
    for i, blk in enumerate(params["blocks"]):
        x, aux, _ = T.block_forward(blk, x, cfg, i, positions=pos)
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
    x = L.norm_forward(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), aux_total


def _lm_head(params, x, cfg):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)) * cfg.logit_scale
    if cfg.padded_vocab() != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def decode_step(params: Params, batch: Dict[str, torch.Tensor],
                caches: Params, cfg: ModelConfig,
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  batch["tokens"]: (B,1).  Returns (logits (B,1,V),
    updated caches); the layers' buffers are updated in place.  MoE aux
    losses are dropped, as in the reference."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S != 1:
        raise ValueError(f"decode_step takes one token per row, got {S}")
    idx = caches["index"]
    cdt = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt) * cfg.emb_scale
    pos = batch.get("positions")
    if pos is None:
        pos = idx.to(torch.int32).reshape(1, 1).expand(B, 1)
    new_layers = []
    for i, blk in enumerate(params["blocks"]):
        x, _, nc = T.block_forward(blk, x, cfg, i, positions=pos,
                                   cache=caches["layers"][i], cache_index=idx)
        new_layers.append(nc)
    x = L.norm_forward(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), {"layers": new_layers, "index": idx + 1}


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy plus the MoE aux losses.  ``logsumexp −
    gather`` takes the place of the reference's one-hot contraction (same
    value, no (B,S,V) one-hot)."""
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
