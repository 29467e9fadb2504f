"""Two-level hierarchical strategy (beyond-paper; port of
``repro/strategies/hierarchical.py``).

Inner (in-pod) syncs average contiguous replica groups at a small constant
period; the outer (cross-pod) sync is the paper's adaptive one.  The group
size is ``cfg.group_size``, else the backend's topology
(``backend.default_group_size()``), else half the replicas, lowered to a
divisor of R.  An outer sync subsumes the pending inner one.  The inner
average is the ``inner_mean(group)`` CollectiveOp, an in-place view and
mean on the vmap backend; the group rides the descriptor, so pricing sees
the group, never the world.

Comm accounting inherits the base hooks: the analytic model prices the
cross-pod link, which only outer syncs use; inner syncs show in
``TrainHistory.inner_sync_steps`` and in a clock's Timeline.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.backends.ops import inner_mean_op
from repro_torch.core.controller import HierarchicalADPSGDController
from repro_torch.strategies.base import (INNER_SYNC, STEP, SYNC,
                                         register_strategy)
from repro_torch.strategies.periodic import PeriodicAveragingStrategy
from repro_torch.tree import tree_leaves


@register_strategy
class HierarchicalADPSGDStrategy(PeriodicAveragingStrategy):
    """Inner constant-period group sync + outer adaptive sync."""

    name = "hier_adpsgd"
    controller_cls = HierarchicalADPSGDController

    def set_controller(self, controller) -> None:
        # actions() needs the two-level interface, not just sync_now
        if not isinstance(controller, HierarchicalADPSGDController):
            raise TypeError("hier_adpsgd needs a HierarchicalADPSGDController, "
                            f"got {type(controller).__name__}")
        self.controller = controller

    def _build_programs(self, loss_fn, optimizer, backend):
        programs = super()._build_programs(loss_fn, optimizer, backend)
        group_cfg = self.cfg.group_size
        built: Dict[int, Any] = {}

        def inner_prog(W, opt_state, batch, lr, key):
            # every replica, wherever they live (W may be one process's)
            R = backend.n_replicas or tree_leaves(W)[0].shape[0]
            g = group_cfg or backend.default_group_size() or max(1, R // 2)
            while R % g:
                g -= 1
            if g not in built:
                built[g] = backend.lower(inner_mean_op(g))
            return built[g](W), opt_state, {"inner_sync": True}

        programs[INNER_SYNC] = inner_prog
        return programs

    def actions(self, k: int):
        if self.controller.sync_now(k):
            self._comm_events += 1
            # the global average subsumes the in-group one
            self.controller.reset_inner()
            return (STEP, SYNC)
        if self.controller.inner_sync_now(k):
            return (STEP, INNER_SYNC)
        return (STEP,)
