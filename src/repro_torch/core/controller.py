"""Host-side averaging-period controllers (port of
``repro/core/controller.py``; the AdaComm and hierarchical controllers are
not ported yet).

The controller decides, each iteration, whether the sync program runs after
the local step, and adapts the period from the measured variance probe S_k
(paper Algorithm 2) plus the baselines it is compared against.  Plain
python, so the decisions are identical to the reference's for the same
S_k / lr sequence.
"""
from __future__ import annotations

from typing import List

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
