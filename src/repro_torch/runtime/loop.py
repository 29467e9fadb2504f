"""Back-compat shim over the strategy-driven engine (port of
``repro/runtime/loop.py``).

``train_periodic`` is the seed's one-call entry point: it builds a
``TrainerEngine`` through the strategy registry and runs it.  New code
constructs ``TrainerEngine`` directly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import AveragingConfig
from repro_torch.core.controller import PeriodController
from repro_torch.device import DeviceLike
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.engine import (  # noqa: F401  (re-exported API)
    TrainerEngine, TrainHistory, evaluate,
)
from repro_torch.strategies import make_strategy
from repro_torch.strategies.periodic import PeriodicAveragingStrategy

Pytree = Any


def train_periodic(*,
                   loss_fn,
                   optimizer: Optimizer,
                   params0: Pytree,
                   n_replicas: int,
                   data_fn: Callable[[int], Dict[str, torch.Tensor]],
                   lr_fn: Callable[[int], float],
                   avg_cfg: AveragingConfig,
                   total_steps: int,
                   track_variance_every: int = 0,
                   seed: int = 0,
                   controller: Optional[PeriodController] = None,
                   device: DeviceLike = None,
                   ) -> TrainHistory:
    """Build a ``TrainerEngine`` via the strategy registry and run it.
    ``controller``, if given, is installed into a periodic strategy."""
    strategy = make_strategy(avg_cfg, total_steps)
    if controller is not None and isinstance(strategy,
                                             PeriodicAveragingStrategy):
        # every-step strategies (fullsgd / qsgd) never read a controller
        strategy.set_controller(controller)
    engine = TrainerEngine(
        loss_fn=loss_fn, optimizer=optimizer, params0=params0,
        n_replicas=n_replicas, data_fn=data_fn, lr_fn=lr_fn,
        avg_cfg=avg_cfg, total_steps=total_steps, strategy=strategy,
        track_variance_every=track_variance_every, seed=seed, device=device)
    return engine.run()
