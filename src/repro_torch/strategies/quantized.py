"""Quantized-communication strategies (port of
``repro/strategies/quantized.py``).

``qsgd``          — the paper's every-step baseline (Alistarh et al. 2017):
                    8-bit stochastic gradient quantization, full-frequency
                    communication at qsgd_bits/32 of the FULLSGD volume.
``qsgd_periodic`` — QSGD-quantized parameter deltas exchanged on the
                    adaptive periodic-averaging schedule (Algorithm 2).

The composed sync keeps a full-precision anchor (the last agreed average).
The first sync transmits full precision to seed it; after that each
replica quantizes its delta from the anchor into the byte-true payload
(int8 levels plus per-tensor norms, ``ops.quantized_all_mean_op``), the
receiver dequantizes, and anchor + mean(dequantized deltas) becomes the
agreed value.  S_k is measured on the dequantized deltas, the statistic
the controller reads.  The anchor is training state: ``state_dict``
exports a copy of it under ``_arrays`` (the live anchor moves in place at
every sync), so a resumed run goes on with quantized exchanges instead of
paying another full-precision seeding sync.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.backends.ops import (opt_mean_op, qsgd_step_op,
                                      quantized_all_mean_op)
from repro_torch.core.controller import ADPSGDController
from repro_torch.strategies.base import (STEP, SYNC, CommunicationStrategy,
                                         register_strategy)
from repro_torch.strategies.periodic import PeriodicAveragingStrategy
from repro_torch.tree import tree_map


@register_strategy
class QSGDStrategy(CommunicationStrategy):
    """Every-step stochastic gradient quantization (paper §IV baseline)."""

    name = "qsgd"

    def step_op(self):
        return qsgd_step_op(self.cfg.qsgd_bits)

    def sync_op(self):
        # the communication event is the fused quantized-gradient step
        return qsgd_step_op(self.cfg.qsgd_bits)

    def _build_programs(self, loss_fn, optimizer, backend):
        step = backend.lower(self.step_op(),
                             loss_fn=loss_fn, optimizer=optimizer)

        def step_prog(W, opt_state, batch, lr, key):
            W, opt_state, metrics = step(W, opt_state, batch, lr, key)
            return W, opt_state, dict(metrics)

        return {STEP: step_prog}

    def actions(self, k: int):
        self._comm_events += 1
        return (STEP,)

    def comm_events_for(self, total_steps: int, n_syncs: int) -> int:
        return total_steps


@register_strategy
class QSGDPeriodicStrategy(PeriodicAveragingStrategy):
    """Quantized deltas on the adaptive periodic schedule (composition)."""

    name = "qsgd_periodic"
    controller_cls = ADPSGDController

    def __init__(self, cfg, total_steps: int, **kw):
        super().__init__(cfg, total_steps, **kw)
        self._anchor = None          # full-precision last agreed average

    def sync_op(self):
        return quantized_all_mean_op(self.cfg.qsgd_bits)

    def _build_programs(self, loss_fn, optimizer, backend):
        programs = super()._build_programs(loss_fn, optimizer, backend)
        full_sync_prog = programs[SYNC]        # the full-precision sync
        qsync = backend.lower(self.sync_op())
        opt_mean = (backend.lower(opt_mean_op())
                    if self.cfg.sync_momentum else None)

        def sync_prog(W, opt_state, batch, lr, key):
            if self._anchor is None:
                # seed the anchor: one full-precision sync
                W, opt_state, info = full_sync_prog(W, opt_state, batch, lr,
                                                    key)
                self._anchor = self.backend.collapse(W)
                return W, opt_state, info
            W, self._anchor, s_k = qsync(W, self._anchor, key)
            if opt_mean is not None and opt_state is not None:
                opt_state = opt_mean(opt_state)
            return W, opt_state, {"s_k": s_k}

        programs[SYNC] = sync_prog
        return programs

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        if self._anchor is not None:
            d["_arrays"] = {"anchor": tree_map(torch.clone, self._anchor)}
        return d

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        arrays = state.get("_arrays") or {}
        if "anchor" in arrays:
            anchor = arrays["anchor"]
            if self.backend is not None:
                anchor = self.backend.put_replicated(self.backend.own(anchor))
            self._anchor = anchor
