"""DaSGD: delayed averaging overlaps the sync with compute
(arXiv:2006.00441; port of ``repro/strategies/dasgd.py``).

The average computed from the parameters at step k is applied at step
k + d (``cfg.dasgd_delay``), and the replicas keep taking local steps in
between, so each holds ``w_i(k+d) + (w̄(k) − w_i(k))``: the agreed average
plus its own progress of the overlap window.

The snapshot is an ``overlap=True`` CollectiveOp (``ops.mean_delta_op``):
dispatching it returns an ``InFlightOp`` at once, with no host read of
the probe.  Its work is queued on the same CUDA stream as the local steps,
which update W in place, so stream order makes it read W(k) before step
k + 1 writes W; a side stream would race with that in-place step.  Two
programs make the pair:

* ``sync`` (snapshot) — dispatches ``mean_delta``: the correction
  ``w̄ − w_i`` (an f32 buffer) and the probe S_k, fetched d steps later;
* ``sync_apply`` — fetches the in-flight op and adds the correction in
  place (collective-free).  The probe reaches the engine as
  ``s_k_at=(snapshot_step, S_k)``, attributed to the snapshot iteration.

Warm-up iterations (``warmup_full_sync_steps``) use the immediate full
sync.

The in-flight correction is training state.  A checkpoint is a
synchronisation point: ``state_dict`` fetches the in-flight op, keeps the
fetched pair live, and exports the correction and its probe under
``_arrays`` with the due step and the snapshot step, so a resumed run
applies the identical correction at the identical iteration and reports
the identical S_k.  The correction is ``mean_delta``'s own f32 buffer,
which no program writes (the local steps write W; ``sync_apply`` reads
it), so the state holds it as it is; on the mesh backend, whose in-flight
op holds the all-reduce's work handle until it is fetched, the state
holds every process's rows (``backend.gather_replicas``) and a restore
keeps this process's (``backend.local_replicas``).  A run segment that
ends between a snapshot and its apply has counted the communication event
but not yet recorded its probe: the probe belongs to the segment that
fetches it.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.backends.ops import InFlightOp, apply_delta_op, mean_delta_op
from repro_torch.core.controller import ConstantPeriodController
from repro_torch.strategies.base import STEP, SYNC, register_strategy
from repro_torch.strategies.periodic import PeriodicAveragingStrategy

SYNC_APPLY = "sync_apply"
FULL_SYNC = "full_sync"


@register_strategy
class DaSGDStrategy(PeriodicAveragingStrategy):
    """Constant-period averaging applied ``dasgd_delay`` steps late."""

    name = "dasgd"
    controller_cls = ConstantPeriodController

    def __init__(self, cfg, total_steps: int, **kw):
        super().__init__(cfg, total_steps, **kw)
        # the overlap window stays shorter than the period, so a new
        # snapshot never lands while one is in flight
        self.delay = max(1, min(int(cfg.dasgd_delay), max(1, cfg.p_const - 1)))
        self._pending = None          # InFlightOp | fetched (delta, s_k)
        self._apply_at = None         # step the correction is due
        self._snap_at = None          # step the snapshot was taken

    def sync_op(self):
        return mean_delta_op(overlap=True)

    def _build_programs(self, loss_fn, optimizer, backend):
        programs = super()._build_programs(loss_fn, optimizer, backend)
        programs[FULL_SYNC] = programs[SYNC]   # warm-up: immediate sync
        delta_fn = backend.lower(self.sync_op())
        apply_fn = backend.lower(apply_delta_op())

        def snapshot_prog(W, opt_state, batch, lr, key):
            # an InFlightOp: nothing here waits for the exchange
            self._pending = delta_fn(W)
            return W, opt_state, {"overlap_dispatch": True}

        def apply_prog(W, opt_state, batch, lr, key):
            delta, s_k = self._fetch_pending()
            W = apply_fn(W, delta)
            info: Dict[str, Any] = {"delayed_apply": True}
            if s_k is not None and self._snap_at is not None:
                info["s_k_at"] = (self._snap_at, s_k)
            self._pending = None
            self._snap_at = None
            return W, opt_state, info

        programs[SYNC] = snapshot_prog
        programs[SYNC_APPLY] = apply_prog
        return programs

    def _fetch_pending(self):
        p = self._pending
        if isinstance(p, InFlightOp):
            p = p.fetch()
        return p

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d["apply_at"] = self._apply_at
        d["snap_at"] = self._snap_at
        pending = self._fetch_pending()    # a checkpoint is a sync point
        if pending is not None:
            self._pending = pending        # keep the fetched pair live
            delta, s_k = pending
            arrays = d.setdefault("_arrays", {})
            arrays["pending_delta"] = (delta if self.backend is None else
                                       self.backend.gather_replicas(delta))
            if s_k is not None:
                arrays["pending_s_k"] = s_k
        return d

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._apply_at = state.get("apply_at")
        if self._apply_at is not None:
            self._apply_at = int(self._apply_at)
        self._snap_at = state.get("snap_at")
        if self._snap_at is not None:
            self._snap_at = int(self._snap_at)
        arrays = state.get("_arrays") or {}
        if "pending_delta" in arrays:
            pending = arrays["pending_delta"]
            s_k = arrays.get("pending_s_k")
            if self.backend is not None:
                pending = self.backend.put_params(self.backend.own(
                    self.backend.local_replicas(pending)))
                if s_k is not None:
                    s_k = self.backend.own(s_k)
            # a checkpoint taken before the probe was reported carries
            # none: apply without reporting it again
            self._pending = (pending, s_k)
        else:
            # nothing in flight: drop any stale due step so apply never
            # meets a missing correction
            self._pending = None
            self._apply_at = None
            self._snap_at = None

    def actions(self, k: int):
        acts = [STEP]
        if self._apply_at is not None and k >= self._apply_at:
            acts.append(SYNC_APPLY)
            self._apply_at = None
        if self.controller.sync_now(k):
            if k < self.cfg.warmup_full_sync_steps:
                self._comm_events += 1
                acts.append(FULL_SYNC)
            elif self._apply_at is None:
                self._comm_events += 1
                acts.append(SYNC)
                self._apply_at = k + self.delay
                self._snap_at = k
        return tuple(acts)
