"""Block composition (port of ``repro/models/transformer.py``): a pre-norm
mixer sublayer, picked per layer by ``cfg.layer_pattern`` (GQA or MLA
attention, the Mamba selective SSM, the mLSTM or the sLSTM), a
feed-forward sublayer (SwiGLU or GELU MLP, or mixture of experts; none
after an xLSTM block, which carries its own projections) and, in an
encoder-decoder (whisper), a cross-attention sublayer, over the full
sequence or one token against the block's cache (the attention's KV
cache, or the recurrent state of the other mixers); and whisper's
bidirectional encoder tower."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import xlstm as X

Params = Dict[str, Any]


def _has_ffn(cfg: ModelConfig, layer_idx: int) -> bool:
    if cfg.block_kind(layer_idx) in ("mlstm", "slstm"):
        return False                      # xLSTM blocks are self-contained
    return cfg.d_ff > 0 or cfg.moe is not None


def init_block(key: prng.Key, cfg: ModelConfig, layer_idx: int, *,
               device: DeviceLike = None) -> Params:
    """The key splits 4 ways as the reference's: norm1, the mixer (under
    the block kind's name), norm2, the feed-forward: experts where
    ``layer_uses_moe``, else an MLP of width ``d_ff_dense or d_ff`` below
    ``first_k_dense`` and ``d_ff`` above."""
    ks = prng.split(key, 4)
    kind = cfg.block_kind(layer_idx)
    p: Params = {"norm1": L.init_norm(ks[0], cfg, cfg.d_model, device=device)}
    if kind == "attn":
        p["attn"] = L.init_attention(ks[1], cfg, device=device)
    elif kind == "mamba":
        p["mamba"] = M.init_mamba(ks[1], cfg, device=device)
    elif kind == "mlstm":
        p["mlstm"] = X.init_mlstm(ks[1], cfg, device=device)
    elif kind == "slstm":
        p["slstm"] = X.init_slstm(ks[1], cfg, device=device)
    else:
        raise ValueError(kind)
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
    """The attention's cache (GQA's ring buffer or MLA's latent cache) in
    ``dtype``; the other mixers' recurrent state in f32 whatever
    ``dtype`` is, as the reference's."""
    kind = cfg.block_kind(layer_idx)
    if kind == "attn":
        return L.init_kv_cache(cfg, batch, max_len, dtype, device=device)
    if kind == "mamba":
        return M.init_mamba_state(cfg, batch, device=device)
    if kind == "mlstm":
        return X.init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return X.init_slstm_state(cfg, batch, device=device)
    raise ValueError(kind)


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                  *, positions: torch.Tensor,
                  cache: Optional[Params] = None,
                  cache_index: Optional[torch.Tensor] = None,
                  cross_kv: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                  mrope_pos: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             Optional[Params]]:
    """Returns (x, the feed-forward's aux losses — empty but for MoE —,
    the block's updated cache — None without a cache).  The attention
    updates its KV cache in place and returns it; the recurrent mixers
    return their new state as new tensors.  The cross sublayer (a block
    with ``cross`` given ``cross_kv``) runs after the feed-forward, as in
    the reference, which documents the choice; the published whisper puts
    it between self-attention and the MLP."""
    kind = cfg.block_kind(layer_idx)
    h = L.norm_forward(p["norm1"], x, cfg)
    new_cache = None
    if kind == "attn":
        h, new_cache = L.attention_forward(
            p["attn"], h, cfg, positions=positions, cache=cache,
            cache_index=cache_index, mrope_pos=mrope_pos)
    elif kind == "mamba":
        h, new_cache = M.mamba_forward(p["mamba"], h, cfg, state=cache)
    elif kind == "mlstm":
        h, new_cache = X.mlstm_forward(p["mlstm"], h, cfg, state=cache)
    elif kind == "slstm":
        h, new_cache = X.slstm_forward(p["slstm"], h, cfg, state=cache)
    x = x + h * cfg.residual_scale
    aux: Dict[str, torch.Tensor] = {}
    if "norm2" in p:
        h = L.norm_forward(p["norm2"], x, cfg)
        if "moe" in p:
            h, aux = L.moe_forward(p["moe"], h, cfg)
        else:
            h = L.mlp_forward(p["mlp"], h, cfg)
        x = x + h * cfg.residual_scale
    if cross_kv is not None and "cross" in p:
        h = L.norm_forward(p["cross_norm"], x, cfg)
        h, _ = L.attention_forward(p["cross"], h, cfg, positions=positions,
                                   cross_kv=cross_kv)
        x = x + h * cfg.residual_scale
    return x, aux, new_cache


def init_cross_attention(key: prng.Key, cfg: ModelConfig, p: Params, *,
                         device: DeviceLike = None) -> Params:
    """Adds the cross-attention (``ks[0]``) and its norm to block ``p``."""
    ks = prng.split(key, 2)
    p["cross"] = L.init_attention(ks[0], cfg, device=device)
    p["cross_norm"] = L.init_norm(ks[1], cfg, cfg.d_model, device=device)
    return p


# ---------------------------------------------------------------------------
# Encoder tower (whisper): bidirectional, sinusoidal positions
# ---------------------------------------------------------------------------


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The decoder's config with the encoder's heads (MHA, d_head from
    d_model), no layer pattern, no experts, no positions in attention."""
    e = cfg.encoder
    return dataclasses.replace(cfg, n_heads=e.n_heads, n_kv_heads=e.n_heads,
                               layer_pattern=None, moe=None, d_head=0,
                               pos_type="none", sliding_window=0)


def init_encoder(key: prng.Key, cfg: ModelConfig, *,
                 device: DeviceLike = None) -> Params:
    """The reference's draws: the key splits ``n_layers + 1`` ways; layer
    i's attention from ``fold_in(ks[i], 1)``, its MLP from
    ``fold_in(ks[i], 3)``."""
    e, ecfg = cfg.encoder, _encoder_cfg(cfg)
    ks = prng.split(key, e.n_layers + 1)
    blocks = [{
        "norm1": L.init_norm(ks[i], ecfg, cfg.d_model, device=device),
        "attn": L.init_attention(prng.fold_in(ks[i], 1), ecfg, device=device),
        "norm2": L.init_norm(prng.fold_in(ks[i], 2), ecfg, cfg.d_model,
                             device=device),
        "mlp": L.init_mlp(prng.fold_in(ks[i], 3), ecfg, device=device),
    } for i in range(e.n_layers)]
    return {"blocks": blocks,
            "final_norm": L.init_norm(ks[-1], ecfg, cfg.d_model,
                                      device=device)}


def encoder_forward(p: Params, frames: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """frames: (B,T,D) post-frontend embeddings (the stub).  Sinusoidal
    positions, then each block: bidirectional attention (``_sdpa`` under an
    all-true mask; never flash, as in the reference) and the MLP, each
    pre-norm with a plain residual; the final norm.  Where the reference
    scans the blocks under ``jax.checkpoint`` (``cfg.remat`` and
    ``cfg.scan_layers``, two blocks or more), each block runs under its
    own checkpoint that saves nothing, whatever ``cfg.remat_policy`` is;
    otherwise, and with grad disabled, a plain loop."""
    e, ecfg = cfg.encoder, _encoder_cfg(cfg)
    B, T, D = frames.shape
    dh = D // e.n_heads
    x = frames + L.sinusoidal_embedding(T, D, frames.device).to(
        frames.dtype)[None]
    mask = torch.ones((B, T, T), dtype=torch.bool, device=frames.device)

    def block(x, blk):
        h = L.norm_forward(blk["norm1"], x, ecfg)
        q, k, v = (L.dense(blk["attn"][w], h).reshape(B, T, e.n_heads, dh)
                   for w in ("wq", "wk", "wv"))
        o = L._sdpa(q, k, v, mask)
        x = x + L.dense(blk["attn"]["wo"], o.reshape(B, T, D))
        h = L.norm_forward(blk["norm2"], x, ecfg)
        return x + L.mlp_forward(blk["mlp"], h, ecfg)

    remat = (cfg.remat and cfg.scan_layers and len(p["blocks"]) >= 2
             and torch.is_grad_enabled())
    for blk in p["blocks"]:
        x = remat_call(block, "nothing", x, blk) if remat else block(x, blk)
    return L.norm_forward(p["final_norm"], x, ecfg)


# the ops whose outputs the "dots" policy saves, as jax's dots_saveable
# saves every dot_general: what dense, einsum and bmm lower to
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "dot")


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep each of ``DOT_OPS``' outputs, recompute the
    rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op._schema.name.split("::")[1] in DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` under one activation checkpoint (non-reentrant, so
    ``torch.autograd.grad`` may take it): the outputs of its ops are not
    kept for the backward but computed again there, from ``args`` and
    what ``fn`` closes over.  ``policy`` is ``cfg.remat_policy``:
    "nothing" saves nothing inside (jax's ``nothing_saveable``), "dots"
    saves the outputs of ``DOT_OPS`` (``dots_saveable``).  The recompute
    runs under the torch-function modes of the forward it repeats (the
    ``replica_tp`` step's ``WholeWhereRefused``), which the backward is
    not under; it reads them with torch's private
    ``_get_current_function_mode_stack``, the same in torch 2.11 and
    2.13.  No forward draws random numbers, so no generator state is kept."""
    import contextlib
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils import checkpoint as ckpt
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {policy!r}: nothing | dots")
    modes = _get_current_function_mode_stack()

    @contextlib.contextmanager
    def under_modes(inner):
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            stack.enter_context(inner)
            yield

    def contexts():
        forward, recompute = (
            ckpt.create_selective_checkpoint_contexts(_save_dots)
            if policy == "dots"
            else (contextlib.nullcontext(), contextlib.nullcontext()))
        return forward, under_modes(recompute)

    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=contexts)
