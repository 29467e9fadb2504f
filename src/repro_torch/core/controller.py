"""Host-side averaging-period controllers (port of
``repro/core/controller.py``).

The controller decides, each iteration, whether the sync program runs after
the local step, and adapts the period from the measured variance probe S_k
(paper Algorithm 2) plus the baselines it is compared against.  Plain
python, so the decisions are identical to the reference's for the same
S_k / lr sequence.
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.configs.base import AveragingConfig


class PeriodController:
    """Base: call ``sync_now(k)`` once per iteration k; if it returns True,
    run the sync program and feed the measured S_k back via
    ``observe(k, lr, S_k)``."""

    name = "base"

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        self.cfg = cfg
        self.total_steps = total_steps
        self.cnt = 0
        self.sync_steps: List[int] = []
        self.period_history: List[int] = []

    @property
    def period(self) -> int:
        raise NotImplementedError

    def sync_now(self, k: int) -> bool:
        if k < self.cfg.warmup_full_sync_steps:
            self._record(k)
            return True
        self.cnt += 1
        if self.cnt >= self.period:
            self.cnt = 0
            self._record(k)
            return True
        return False

    def _record(self, k: int):
        self.sync_steps.append(k)
        self.period_history.append(self.period)

    def observe(self, k: int, lr: float, s_k: float) -> None:
        pass

    @property
    def n_syncs(self) -> int:
        return len(self.sync_steps)

    def mean_period(self, total_steps: Optional[int] = None) -> float:
        t = total_steps or self.total_steps
        return t / max(1, self.n_syncs)

    # adaptive state for checkpoint/resume: restoring must continue the
    # identical sync schedule
    _STATE_ATTRS = ("cnt",)

    def state_dict(self) -> dict:
        return {a: getattr(self, a) for a in self._STATE_ATTRS
                if hasattr(self, a)}

    def load_state_dict(self, state: dict) -> None:
        for a in self._STATE_ATTRS:
            if a in state and hasattr(self, a):
                setattr(self, a, state[a])


class FullSyncController(PeriodController):
    """FULLSGD: synchronize every iteration (p = 1)."""

    name = "fullsgd"

    @property
    def period(self) -> int:
        return 1


class ConstantPeriodController(PeriodController):
    """CPSGD (Algorithm 1): constant period p."""

    name = "cpsgd"

    @property
    def period(self) -> int:
        return self.cfg.p_const


class DecreasingPeriodController(PeriodController):
    """Wang & Joshi's decreasing schedule (paper §V-B — shown harmful):
    period p0 for the first half of training, p1 afterwards."""

    name = "decreasing"

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        super().__init__(cfg, total_steps)
        self.switch = total_steps // 2
        self._k = 0

    def sync_now(self, k: int) -> bool:
        self._k = k
        return super().sync_now(k)

    @property
    def period(self) -> int:
        return self.cfg.decreasing_p0 if self._k < self.switch \
            else self.cfg.decreasing_p1


class ADPSGDController(PeriodController):
    """Algorithm 2 — the paper's contribution.

    * iterations < warmup_full_sync_steps: period 1 (paper: first epoch).
    * first K_s iterations: period = p_init while sampling
      C2 = RunningAverage(S_k / γ_k) at each sync (line 14).
    * afterwards: p += 1 when S_k < 0.7·γ_k·C2, p −= 1 when
      S_k > 1.3·γ_k·C2 (lines 16–19).
    """

    name = "adpsgd"
    _STATE_ATTRS = ("cnt", "p", "c2", "n_c2")

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        super().__init__(cfg, total_steps)
        self.p = cfg.p_init
        self.c2 = 0.0
        self.n_c2 = 0
        self.k_sample = int(cfg.k_sample_frac * total_steps)

    @property
    def period(self) -> int:
        return self.p

    def observe(self, k: int, lr: float, s_k: float) -> None:
        if k < self.cfg.warmup_full_sync_steps:
            return
        if k < self.k_sample:
            self.n_c2 += 1
            self.c2 += (s_k / max(lr, 1e-12) - self.c2) / self.n_c2
            return
        if self.n_c2 == 0:      # degenerate: no sampling window
            self.n_c2 = 1
            self.c2 = s_k / max(lr, 1e-12)
            return
        target = lr * self.c2
        if s_k < self.cfg.lower * target:
            self.p = min(self.p + 1, self.cfg.p_max)
        elif s_k > self.cfg.upper * target:
            self.p = max(self.p - 1, self.cfg.p_min)


class AdaCommController(PeriodController):
    """Wang & Joshi's AdaComm (arXiv:1810.08313, Alg. 2): training is cut
    into blocks of ``adacomm_interval`` iterations; at each block boundary
    the period is reset to

        tau_j = ceil( tau_0 * sqrt( F(w_j) / F(w_0) ) )

    where F is the mean training loss of the block just finished and
    F(w_0) the first block's (the calibration block keeps tau_0 = p_init).
    The losses arrive through ``observe_loss``."""

    name = "adacomm"
    _STATE_ATTRS = ("cnt", "tau", "f0", "_loss_sum", "_loss_n")

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        super().__init__(cfg, total_steps)
        self.tau0 = max(1, cfg.p_init)
        self.tau = self.tau0
        self.interval = max(1, cfg.adacomm_interval)
        self.f0: Optional[float] = None
        self._loss_sum = 0.0
        self._loss_n = 0

    @property
    def period(self) -> int:
        return self.tau

    def observe_loss(self, k: int, loss) -> None:
        # lazy: when the engine defers its loss read-back (the sampled
        # WallClock), ``loss`` is a device scalar and the sum stays on the
        # device until a block boundary; with floats it is the reference's
        # f64 sum, bit for bit
        self._loss_sum = self._loss_sum + loss
        self._loss_n += 1
        if (k + 1) % self.interval == 0 and self._loss_n:
            f = float(self._loss_sum) / self._loss_n
            if self.f0 is None:
                self.f0 = f                     # calibration block
            else:
                self.tau = int(min(max(
                    math.ceil(self.tau0 * math.sqrt(max(f, 0.0) / self.f0)),
                    self.cfg.p_min), self.cfg.p_max))
            self._loss_sum = 0.0
            self._loss_n = 0

    def state_dict(self) -> dict:
        self._loss_sum = float(self._loss_sum)
        return super().state_dict()


class AdaCommTimeController(AdaCommController):
    """AdaComm's wall-clock form (arXiv:1810.08313 §4): every ``adacomm_t0``
    seconds of (measured or simulated) run time the period is recomputed
    from the block's mean loss.  On a slow network fewer iterations fit a
    block, its loss is higher, and the period stays larger.  A straggler
    slowdown s divides the loss-derived period by sqrt(s).  Time comes
    from the engine's Clock (``bind_clock``); ``_block_start`` is in clock
    coordinates."""

    name = "adacomm_time"
    _STATE_ATTRS = ("cnt", "tau", "f0", "_loss_sum", "_loss_n",
                    "_block_start")

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        super().__init__(cfg, total_steps)
        self.t0 = float(cfg.adacomm_t0)
        self.clock = None
        self._block_start: Optional[float] = None

    def bind_clock(self, clock) -> None:
        if clock is None:
            raise ValueError(
                "adacomm_mode='time' adapts per wall-clock block and needs "
                "a Clock: pass clock= to TrainerEngine (--net on the "
                "training CLI, e.g. --net 10gbps or --net real)")
        self.clock = clock

    def observe_loss(self, k: int, loss) -> None:
        self._loss_sum = self._loss_sum + loss   # lazy, as above
        self._loss_n += 1
        now = self.clock.now()
        if self._block_start is None:
            self._block_start = now
        if now - self._block_start < self.t0:
            return
        f = float(self._loss_sum) / self._loss_n
        if self.f0 is None:
            self.f0 = f                         # calibration block
        else:
            s = max(1.0, float(self.clock.straggler_factor()))
            tau = math.ceil(self.tau0 * math.sqrt(max(f, 0.0) / self.f0)
                            / math.sqrt(s))
            self.tau = int(min(max(tau, self.cfg.p_min), self.cfg.p_max))
        self._loss_sum = 0.0
        self._loss_n = 0
        self._block_start = now


class HierarchicalADPSGDController(ADPSGDController):
    """Beyond-paper two-level schedule: the inner (in-pod) sync runs at the
    constant period ``inner_period``, the outer (cross-pod) sync is
    ADPSGD's.  ``sync_now`` is the outer sync; ``inner_sync_now`` the
    inner one."""

    name = "hier_adpsgd"
    _STATE_ATTRS = ("cnt", "p", "c2", "n_c2", "_inner_cnt")

    def __init__(self, cfg: AveragingConfig, total_steps: int,
                 inner_period: Optional[int] = None):
        super().__init__(cfg, total_steps)
        if inner_period is None:
            inner_period = getattr(cfg, "inner_period", 1)
        self.inner_period = max(1, inner_period)
        self._inner_cnt = 0
        self.inner_sync_steps: List[int] = []

    def inner_sync_now(self, k: int) -> bool:
        self._inner_cnt += 1
        if self._inner_cnt >= self.inner_period:
            self._inner_cnt = 0
            self.inner_sync_steps.append(k)
            return True
        return False

    def reset_inner(self) -> None:
        """An outer sync equalizes every group, so the in-group count
        restarts."""
        self._inner_cnt = 0


def make_controller(cfg: AveragingConfig, total_steps: int) -> PeriodController:
    """Controller for ``cfg.method`` through the strategy registry's
    ``controller_cls`` (late import: strategies import this module).
    Every-step strategies declare none and get the period-1
    FullSyncController."""
    from repro_torch.strategies import get_strategy_cls
    cls = getattr(get_strategy_cls(cfg.method), "controller_cls", None)
    if cls is None:
        cls = FullSyncController
    return cls(cfg, total_steps)
