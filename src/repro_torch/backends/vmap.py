"""Single-device backend: all replicas on one device, the replica axis as
dim 0 of every leaf (port of ``repro/backends/vmap.py``).

The local step loops over the replicas on views of the stacked buffers (the
reference ``vmap``s); the "collectives" are reductions over dim 0.  The
syncs and the QSGD step run the CUDA kernels whenever the parameters are
on the card, unless the backend was built with ``use_kernel=False``.
"""
from __future__ import annotations

import torch

from repro_torch.backends.base import ExecutionBackend, register_backend
from repro_torch.core import averaging as avg
from repro_torch.core import qsgd as qsgd_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.tree import tree_leaves, tree_unflatten


@register_backend
class VmapBackend(ExecutionBackend):
    """All replicas on one device; per-replica loop + dim-0 reductions."""

    name = "vmap"

    def describe(self):
        return dict(super().describe(), use_kernel=self.kernel_policy())

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

    def _lower_inner_mean(self, op):
        g = op.group
        return lambda W: avg.group_sync(W, g)

    def _lower_opt_mean(self, op):
        return avg.sync_opt_state

    def _lower_mean_delta(self, op):
        """DaSGD's snapshot: ``delta = mean − w_i`` per leaf into one f32
        buffer of W's size, and S_k.  With the kernel on, one pass over all
        leaves (the fused kernel's delta mode) whose per-leaf views are the
        delta tree; without, the plain mean and sqdev per leaf, then the
        delta.  W is only read; the work is queued on W's stream, so it
        sees W before the next step writes it.  Returns (delta tree, S_k),
        S_k left on the device."""

        @torch.no_grad()
        def mean_delta(W):
            leaves = tree_leaves(W)
            if self.kernel_on(W):
                out, deltas = kops.param_mean_and_sqdev_out(leaves, "delta")
                _, s_k = kops.param_mean_and_sqdev_many(leaves, "delta", out)
                return tree_unflatten(W, deltas), s_k
            R = leaves[0].shape[0]
            deltas, sks = [], []
            for x in leaves:
                xf = x.to(torch.float32)
                mean, sk = kref.mean_and_sqdev_ref(xf)
                deltas.append(mean.unsqueeze(0) - xf)
                sks.append(sk)
            return tree_unflatten(W, deltas), sum(sks) / R

        return mean_delta

    def _lower_qsgd_step(self, op, *, loss_fn, optimizer):
        return qsgd_mod.make_qsgd_step(loss_fn, optimizer, op.wire.bits,
                                       use_kernel=self.use_kernel is not False)

    def _lower_quantized_all_mean(self, op):
        """Byte-true QSGD-quantized parameter deltas from the shared
        full-precision anchor, leaf by leaf: each replica r quantizes its
        delta ``w_r − anchor`` under ``split(fold_in(key, r),
        n_leaves)[leaf]`` into (int8 levels, norm)
        (``qsgd.quantize_deltas``, the R deltas' norms in one call); the
        receiver dequantizes all R into one (R, ...) f32 buffer, whose
        replica mean moves the anchor, in place, and is written into every
        replica, with Σ_r ||dq_r − mean||² from the same pass
        (``qsgd.apply_deltas``).  Returns (W, anchor, S_k)."""
        bits = op.wire.bits
        kernel = self.use_kernel is not False

        @torch.no_grad()
        def qsync(W, anchor, key):
            leaves, anchors = tree_leaves(W), tree_leaves(anchor)
            R = leaves[0].shape[0]
            keys = qsgd_mod.delta_keys(key, range(R), len(leaves))
            s_k = 0
            for i, (w, a) in enumerate(zip(leaves, anchors)):
                dq = torch.empty(w.shape, dtype=torch.float32,
                                 device=w.device)
                for r, lv, nm in qsgd_mod.quantize_deltas(
                        w, a, keys, i, bits, use_kernel=kernel):
                    dq[r] = qsgd_mod.dequantize(lv, nm, bits,
                                                use_kernel=kernel)
                s_k = s_k + qsgd_mod.apply_deltas(w, a, dq,
                                                  use_kernel=kernel) / R
                del dq
            return W, anchor, s_k

        return qsync
