"""AdaComm: loss-adaptive communication period (Wang & Joshi,
arXiv:1810.08313; port of ``repro/strategies/adacomm.py``).

The period follows the training loss, ``tau_j = ceil(tau_0 *
sqrt(F_j / F_0))``: communicate rarely while the loss is high and more
often as it falls.  The strategy is the plain periodic machinery; only the
controller and the ``observe_loss`` route differ.
"""
from __future__ import annotations

from repro_torch.configs.base import AveragingConfig
from repro_torch.core.controller import (AdaCommController,
                                         AdaCommTimeController)
from repro_torch.strategies.base import register_strategy
from repro_torch.strategies.periodic import PeriodicAveragingStrategy


@register_strategy
class AdaCommStrategy(PeriodicAveragingStrategy):
    """Periodic averaging on AdaComm's schedule.  ``cfg.adacomm_mode``
    picks the block: ``'iterations'`` (``adacomm_interval`` iterations)
    or ``'time'`` (``adacomm_t0`` seconds on the engine's clock, with
    straggler rescaling; ``AdaCommTimeController``)."""

    name = "adacomm"
    controller_cls = AdaCommController

    def __init__(self, cfg: AveragingConfig, total_steps: int, **kw):
        if cfg.adacomm_mode == "time":
            # shadows the class default before the base __init__ builds
            # the controller
            self.controller_cls = AdaCommTimeController
        elif cfg.adacomm_mode != "iterations":
            raise ValueError(
                f"unknown adacomm_mode '{cfg.adacomm_mode}'; "
                "use 'iterations' or 'time'")
        super().__init__(cfg, total_steps, **kw)

    def observe_loss(self, k: int, loss: float) -> None:
        self.controller.observe_loss(k, loss)

    def bind_clock(self, clock) -> None:
        # every process must pick the same periods: a wall clock reads
        # differently in each
        if (self.cfg.adacomm_mode == "time" and clock is not None
                and clock.kind == "wall" and self.backend is not None
                and self.backend.world > 1):
            raise NotImplementedError(
                "adacomm_mode='time' on a wall clock over several processes "
                "would let each process choose its own schedule; use a "
                "SimulatedClock (--net <x>gbps) or one process")
        super().bind_clock(clock)
