"""Step functions shared by the trainer and the server (port of
``repro/launch/steps.py``: ``make_loss_fn``, ``make_prefill_step``,
``make_serve_step``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        return M.lm_loss(params, batch, cfg)
    return loss_fn


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward; returns the last position's logits (B,V).
    With ``cfg.use_flash`` its attention runs the flash-attention kernel."""
    def prefill(params, batch):
        logits, _ = M.forward(params, batch, cfg)
        return logits[:, -1, :]
    return prefill


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (next token (B,), updated caches)."""
    def serve(params, batch, caches):
        logits, caches = M.decode_step(params, batch, caches, cfg)
        return torch.argmax(logits[:, -1, :], dim=-1), caches
    return serve
