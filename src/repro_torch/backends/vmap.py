"""Single-device backend: all replicas on one device, the replica axis as
dim 0 of every leaf (port of ``repro/backends/vmap.py``).

The local step loops over the replicas on views of the stacked buffers (the
reference ``vmap``s); the "collectives" are reductions over dim 0.  The
sync runs the fused mean + sqdev CUDA kernel whenever the parameters are on
the card, unless the backend was built with ``use_kernel=False``.
"""
from __future__ import annotations

from repro_torch.backends.base import ExecutionBackend, register_backend
from repro_torch.core import averaging as avg
from repro_torch.tree import tree_leaves


@register_backend
class VmapBackend(ExecutionBackend):
    """All replicas on one device; per-replica loop + dim-0 reductions."""

    name = "vmap"

    def describe(self):
        d = super().describe()
        d["use_kernel"] = (self.device.type == "cuda"
                           if self.use_kernel is None else self.use_kernel)
        return d

    def kernel_on(self, W) -> bool:
        if self.use_kernel is not None:
            return self.use_kernel
        return tree_leaves(W)[0].is_cuda

    def _lower_replica_step(self, op, *, loss_fn, optimizer):
        return avg.make_local_step(loss_fn, optimizer)

    def _lower_full_step(self, op, *, loss_fn, optimizer):
        return avg.make_full_step(loss_fn, optimizer)

    def _lower_all_mean(self, op, *, sync_momentum=False):
        def all_mean(W, opt_state):
            return avg.sync_replicas(W, opt_state,
                                     sync_momentum=sync_momentum,
                                     use_kernel=self.kernel_on(W))
        return all_mean

    def _lower_opt_mean(self, op):
        return avg.sync_opt_state
