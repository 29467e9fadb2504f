"""Model API: init, full-sequence forward (train / prefill), single-token
decode against caches, and the LM loss (port of ``repro/models/model.py``
for every family: dense, MoE, MLA, the Mamba hybrid, xLSTM, the
vision-language model and the encoder-decoder).

A batch is a dict with keys by family:
  tokens        (B,S) int                     — always
  positions     (B,S) int                     — optional (default arange)
  loss_mask     (B,S-1)                       — optional
  mrope_pos     (3,B,S) int                   — vlm (M-RoPE); text-only
                                                default t = h = w = position
  vision_embeds (B,P,D)                       — vlm patch-embedding stub,
                                                prepended to the tokens
  frames        (B,T,D)                       — audio frontend stub (forward)
  encoder_out   (B,T,D)                       — the encoder's output (decode)
For decode steps it carries a single token column (B,1).  The reference's
``lax.scan`` over layers is a compile device; here the layers run in a
plain Python loop.  Its rematerialisation is honoured: under
``cfg.remat`` a training forward runs each prefix layer, and each group of
``cfg.scan_grouping()``, under one activation checkpoint
(``transformer.py::remat_call``), where the reference's ``jax.checkpoint``
stands; the numbers are the same with it or without.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def init_params(seed: int, cfg: ModelConfig, *,
                device: DeviceLike = None) -> Params:
    """Random parameters from ``seed``, the reference's
    ``init_params(jax.random.PRNGKey(seed), cfg)``: the same key splits
    and ``jax.random.normal`` draws (``core/prng.py``, a few ulps), each
    scaled and then cast to ``param_dtype`` as there.  An encoder-decoder
    adds each attention block's cross-attention, from
    ``fold_in(ks[2 + i], 7)``, and the encoder tower, from ``ks[-1]``."""
    device = resolve_device(device)
    dt = L.dtype_of(cfg.param_dtype)
    ks = prng.split(prng.prng_key(seed), cfg.n_layers + 4)
    embed = prng.normal(ks[0], (cfg.padded_vocab(), cfg.d_model),
                        device=device)
    p: Params = {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": L.init_norm(ks[1], cfg, cfg.d_model, device=device),
        "blocks": [],
    }
    for i in range(cfg.n_layers):
        blk = T.init_block(ks[2 + i], cfg, i, device=device)
        if cfg.encoder is not None and cfg.block_kind(i) == "attn":
            blk = T.init_cross_attention(prng.fold_in(ks[2 + i], 7), cfg,
                                         blk, device=device)
        p["blocks"].append(blk)
    if not cfg.tie_embeddings:
        head = prng.normal(ks[-2], (cfg.d_model, cfg.padded_vocab()),
                           device=device)
        p["lm_head"] = head.div_(cfg.d_model ** 0.5).to(dt)
    if cfg.encoder is not None:
        p["encoder"] = T.init_encoder(ks[-1], cfg, device=device)
    return p


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device: DeviceLike = None) -> Params:
    """One cache per layer — an attention layer's KV cache in ``dtype``, a
    Mamba, mLSTM or sLSTM layer's recurrent state in f32 — and the decode
    index (an int32 scalar tensor on the caches' device)."""
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
    MoE layer's summed over the layers, in layer order).  S includes a
    vision prefix where the batch carries one.  With ``cfg.remat`` and
    grad enabled, each of ``remat_regions(cfg)`` runs under one checkpoint
    of ``cfg.remat_policy``: the residual is kept at the reference's
    boundaries and the rest is recomputed in the backward."""
    x, pos, mrope = _embed_inputs(params, batch, cfg)
    enc_out = _encode_cross(params, batch, cfg)

    def run_layers(x, lo: int, hi: int):
        auxes = []
        for i in range(lo, hi):
            blk = params["blocks"][i]
            x, aux, _ = T.block_forward(
                blk, x, cfg, i, positions=pos,
                cross_kv=_layer_cross_kv(blk, enc_out, cfg), mrope_pos=mrope)
            auxes.append(aux)
        return x, auxes

    aux_total: Dict[str, torch.Tensor] = {}
    remat = cfg.remat and torch.is_grad_enabled()
    for lo, hi in (remat_regions(cfg) if remat else [(0, cfg.n_layers)]):
        if remat:
            x, auxes = T.remat_call(run_layers, cfg.remat_policy, x, lo, hi)
        else:
            x, auxes = run_layers(x, lo, hi)
        for aux in auxes:
            for k, v in aux.items():
                aux_total[k] = aux_total.get(k, 0.0) + v
    x = L.norm_forward(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), aux_total


def remat_regions(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """The layer ranges [lo, hi) that each run under one checkpoint, as
    the reference's forward places ``jax.checkpoint``: each of the
    ``scan_grouping()``'s prefix layers (every layer where it is None)
    alone, then its ``n_groups`` groups of ``period`` layers."""
    grouping = cfg.scan_grouping()
    prefix = cfg.n_layers if grouping is None else grouping[0]
    out = [(i, i + 1) for i in range(prefix)]
    if grouping is not None:
        _, period, n_groups = grouping
        out += [(prefix + g * period, prefix + (g + 1) * period)
                for g in range(n_groups)]
    return out


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """(x, positions, mrope_pos).  The vision prefix joins after
    ``emb_scale`` and is not scaled; positions run over the whole
    prefixed sequence; text-only M-RoPE takes t = h = w = position;
    ``learned`` positions add the sinusoidal table, as the reference's."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cdt = L.dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt) * cfg.emb_scale
    mrope = batch.get("mrope_pos")
    if cfg.vision is not None and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(cdt), x], dim=1)
        S = x.shape[1]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
    if cfg.pos_type == "mrope" and mrope is None:
        mrope = pos[None].expand(3, B, S)
    if cfg.pos_type == "learned":
        x = x + L.sinusoidal_embedding(S, cfg.d_model, x.device).to(cdt)[None]
    return x, pos, mrope


def _encode_cross(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Optional[torch.Tensor]:
    """The encoder's output over ``batch["frames"]``, cast to the compute
    dtype first; None without an encoder."""
    if cfg.encoder is None:
        return None
    frames = batch["frames"].to(L.dtype_of(cfg.compute_dtype))
    return T.encoder_forward(params["encoder"], frames, cfg)


def _layer_cross_kv(blk: Params, enc_out: Optional[torch.Tensor],
                    cfg: ModelConfig):
    """One block's cross-attention keys and values, each (B,Te,K,dh),
    projected from the encoder's output.  Every layer projects them again
    on every call (each decode step too), as the reference does."""
    if enc_out is None or "cross" not in blk:
        return None
    B, Te, _ = enc_out.shape
    shape = (B, Te, cfg.n_kv_heads, cfg.head_dim())
    return (L.dense(blk["cross"]["wk"], enc_out).reshape(shape),
            L.dense(blk["cross"]["wv"], enc_out).reshape(shape))


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
    updated caches): an attention layer's buffers are updated in place, a
    recurrent layer's state is replaced by the new tensors its mixer
    returns.  MoE aux losses are dropped, as in the reference.  M-RoPE
    defaults to t = h = w = position, the learned position is the
    sinusoid at the cache index, and an encoder-decoder reads
    ``batch["encoder_out"]``."""
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
    mrope = batch.get("mrope_pos")
    if cfg.pos_type == "mrope" and mrope is None:
        mrope = pos[None].expand(3, B, 1)
    if cfg.pos_type == "learned":
        pe = L.sinusoids(idx.reshape(1), cfg.d_model)
        x = x + pe.to(cdt)[None]
    enc_out = batch.get("encoder_out")
    new_layers = []
    for i, blk in enumerate(params["blocks"]):
        x, _, nc = T.block_forward(
            blk, x, cfg, i, positions=pos, cache=caches["layers"][i],
            cache_index=idx, cross_kv=_layer_cross_kv(blk, enc_out, cfg),
            mrope_pos=mrope)
        new_layers.append(nc)
    x = L.norm_forward(params["final_norm"], x, cfg)
    return _lm_head(params, x, cfg), {"layers": new_layers, "index": idx + 1}


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy plus the MoE aux losses; a vision prefix
    is not scored.  ``logsumexp − gather`` takes the place of the
    reference's one-hot contraction (same value, no (B,S,V) one-hot)."""
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
