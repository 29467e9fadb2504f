"""Step functions shared by the dry run, the trainer and the server (port
of ``repro/launch/steps.py``: ``make_loss_fn``, ``make_steps``,
``make_prefill_step``, ``make_serve_step``)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import averaging as avg
from repro_torch.models import model as M
from repro_torch.optim import get_optimizer


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        return M.lm_loss(params, batch, cfg)
    return loss_fn


def make_steps(run: RunConfig) -> Dict[str, Callable]:
    """The three training programs of the paper's system on one device's
    replica-stacked (W, opt_state), each updating them in place:
       local_step — Algorithm 1/2 lines 3-4: no exchange between replicas
       sync_step  — parameter averaging and the S_k probe, through the
                    mean + sqdev kernel's wrapper (the kernel on the card,
                    its plain version on the CPU)
       full_step  — FULLSGD baseline (gradients averaged every step)
    plus the ``optimizer`` and the ``loss_fn`` they use."""
    cfg = run.model
    loss_fn = make_loss_fn(cfg)
    opt = get_optimizer(run.optimizer, momentum_coef=run.momentum,
                        weight_decay=run.weight_decay)

    def sync_step(W, opt_state):
        return avg.sync_replicas(
            W, opt_state, sync_momentum=run.averaging.sync_momentum,
            use_kernel=True)

    return {"local_step": avg.make_local_step(loss_fn, opt),
            "sync_step": sync_step,
            "full_step": avg.make_full_step(loss_fn, opt),
            "optimizer": opt, "loss_fn": loss_fn}


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
