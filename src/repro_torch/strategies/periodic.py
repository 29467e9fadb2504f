"""The paper's periodic-averaging strategies plus the FULLSGD baseline
(port of ``repro/strategies/periodic.py``).

``PeriodicAveragingStrategy``: a local step every iteration and the
replica-averaging sync on the schedule its ``PeriodController`` picks
(constant / decreasing / adaptive — Algorithms 1 and 2).  The
controller's state rides the strategy's ``state_dict`` (checkpoints).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type

from repro_torch.backends.ops import all_mean_op, full_step_op
from repro_torch.configs.base import AveragingConfig
from repro_torch.core.controller import (ADPSGDController,
                                         ConstantPeriodController,
                                         DecreasingPeriodController,
                                         PeriodController)
from repro_torch.strategies.base import (STEP, SYNC, CommunicationStrategy,
                                         register_strategy)


class PeriodicAveragingStrategy(CommunicationStrategy):
    """Local SGD + controller-scheduled parameter averaging."""

    name = "periodic"
    controller_cls: Type[PeriodController] = ConstantPeriodController

    def __init__(self, cfg: AveragingConfig, total_steps: int,
                 controller: Optional[PeriodController] = None):
        super().__init__(cfg, total_steps)
        self.controller = self.controller_cls(cfg, total_steps)
        if controller is not None:
            self.set_controller(controller)

    def set_controller(self, controller: PeriodController) -> None:
        if not isinstance(controller, PeriodController):
            raise TypeError(f"expected a PeriodController, "
                            f"got {type(controller).__name__}")
        self.controller = controller

    def _build_programs(self, loss_fn, optimizer, backend):
        step = backend.lower(self.step_op(),
                             loss_fn=loss_fn, optimizer=optimizer)
        sync = backend.lower(all_mean_op(),
                             sync_momentum=self.cfg.sync_momentum)

        def step_prog(W, opt_state, batch, lr, key):
            W, opt_state, metrics = step(W, opt_state, batch, lr)
            return W, opt_state, dict(metrics)

        def sync_prog(W, opt_state, batch, lr, key):
            W, opt_state, s_k = sync(W, opt_state)
            return W, opt_state, {"s_k": s_k}

        return {STEP: step_prog, SYNC: sync_prog}

    def actions(self, k: int):
        if self.controller.sync_now(k):
            self._comm_events += 1
            return (STEP, SYNC)
        return (STEP,)

    def observe(self, k: int, lr: float, s_k: float) -> None:
        self.controller.observe(k, lr, s_k)

    def bind_clock(self, clock) -> None:
        # only time-driven controllers (AdaCommTimeController) declare the
        # hook; they check that a clock is present
        if hasattr(self.controller, "bind_clock"):
            self.controller.bind_clock(clock)

    @property
    def period(self) -> int:
        return self.controller.period

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d.update(self.controller.state_dict())
        return d

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.controller.load_state_dict(state)


@register_strategy
class ConstantPeriodStrategy(PeriodicAveragingStrategy):
    """CPSGD (Algorithm 1): constant period p."""

    name = "cpsgd"
    controller_cls = ConstantPeriodController


@register_strategy
class AdaptivePeriodStrategy(PeriodicAveragingStrategy):
    """ADPSGD (Algorithm 2) — the paper's contribution."""

    name = "adpsgd"
    controller_cls = ADPSGDController


@register_strategy
class DecreasingPeriodStrategy(PeriodicAveragingStrategy):
    """Wang & Joshi's decreasing schedule (paper §V-B — shown harmful)."""

    name = "decreasing"
    controller_cls = DecreasingPeriodController


@register_strategy
class FullSGDStrategy(CommunicationStrategy):
    """FULLSGD: gradients averaged every iteration (p = 1); every step is a
    communication event and the replicas stay identical."""

    name = "fullsgd"

    def step_op(self):
        return full_step_op()

    def sync_op(self):
        return full_step_op()

    def _build_programs(self, loss_fn, optimizer, backend):
        step = backend.lower(self.step_op(),
                             loss_fn=loss_fn, optimizer=optimizer)

        def step_prog(W, opt_state, batch, lr, key):
            W, opt_state, metrics = step(W, opt_state, batch, lr)
            return W, opt_state, dict(metrics)

        return {STEP: step_prog}

    def actions(self, k: int):
        self._comm_events += 1
        return (STEP,)

    def comm_events_for(self, total_steps: int, n_syncs: int) -> int:
        return total_steps
