"""AdaComm: loss-adaptive communication period (Wang & Joshi,
arXiv:1810.08313; port of ``repro/strategies/adacomm.py``).

The period follows the training loss, ``tau_j = ceil(tau_0 *
sqrt(F_j / F_0))``: communicate rarely while the loss is high and more
often as it falls.  The strategy is the plain periodic machinery; only the
controller and the ``observe_loss`` route differ.  On a mesh of several
processes the time blocks end on the world's latest wall-clock reading
(``WorldMaxClock``), so every process keeps one schedule.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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
        # every process must pick the same periods, and a wall clock reads
        # differently in each: the controller reads the world's latest
        if (self.cfg.adacomm_mode == "time" and clock is not None
                and clock.kind == "wall" and self.backend is not None
                and self.backend.world > 1):
            clock = WorldMaxClock(clock, self.backend.mesh.group)
        super().bind_clock(clock)


class WorldMaxClock:
    """A wall clock as the time controller reads it on a mesh of several
    processes: ``now()`` is the maximum of every process's reading, the
    straggler's time, so every process ends its blocks at the same steps.
    The controller reads the clock at every step (each step may end a
    block), so each step costs one f64 all-reduce.  It runs over gloo on
    the host (``group`` itself when it is a gloo group, else a gloo group
    of the same ranks, made here, collectively), so a step never waits
    for the card's stream.  The engine's programs keep timing themselves
    on the process's own clock."""

    def __init__(self, clock, group):
        self.clock = clock
        self.kind = clock.kind
        self.group = group if dist.get_backend(group) == "gloo" else \
            dist.new_group(dist.get_process_group_ranks(group),
                           backend="gloo")

    def now(self) -> float:
        t = torch.tensor([self.clock.now()], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t[0])

    def straggler_factor(self) -> float:
        return self.clock.straggler_factor()
