"""Step functions shared by the trainer (port of
``repro/launch/steps.py::make_loss_fn``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        return M.lm_loss(params, batch, cfg)
    return loss_fn
