"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

``step``   — the paper's schedule (×0.1 at given steps).
``wsd``    — Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395).
``cosine`` — standard cosine with warmup.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence


def make_lr_schedule(kind: str, base_lr: float, total_steps: int, *,
                     warmup_steps: int = 0,
                     decay_steps: Sequence[int] = (),
                     decay_factor: float = 0.1,
                     final_frac: float = 0.1,
                     decay_frac: float = 0.1) -> Callable[[int], float]:
    """Host-side python function step -> lr (the controller needs gamma_k
    on the host for Algorithm 2)."""

    def warmup(k: int) -> float:
        if warmup_steps and k < warmup_steps:
            return base_lr * (k + 1) / warmup_steps
        return -1.0

    if kind == "constant":
        def f(k):
            w = warmup(k)
            return w if w >= 0 else base_lr
    elif kind == "step":
        def f(k):
            w = warmup(k)
            if w >= 0:
                return w
            lr = base_lr
            for s in decay_steps:
                if k >= s:
                    lr *= decay_factor
            return lr
    elif kind == "cosine":
        def f(k):
            w = warmup(k)
            if w >= 0:
                return w
            t = (k - warmup_steps) / max(1, total_steps - warmup_steps)
            return base_lr * (final_frac + (1 - final_frac)
                              * 0.5 * (1 + math.cos(math.pi * min(t, 1.0))))
    elif kind == "wsd":
        decay_start = int(total_steps * (1 - decay_frac))

        def f(k):
            w = warmup(k)
            if w >= 0:
                return w
            if k < decay_start:
                return base_lr
            t = (k - decay_start) / max(1, total_steps - decay_start)
            return base_lr * (final_frac ** min(t, 1.0))
    else:
        raise ValueError(kind)
    return f
