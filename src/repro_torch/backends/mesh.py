"""Multi-GPU backend: the replica axis over processes on
``torch.distributed`` (port of ``repro/backends/mesh.py``, its
``replica_ddp`` placement).

One process per GPU, NCCL between the GPUs (gloo between CPU processes,
with ``device="cpu"``).  Each of the ``world`` ranks holds a contiguous
chunk of ``n_local = R / world`` whole-model replicas, global indices
``rank·n_local … (rank+1)·n_local − 1``, stacked on dim 0 of every leaf
as on the ``vmap`` backend.  The strategies' syncs become real
collectives, and their number does not depend on the number of leaves:

* the local step (``replica_step``) is ``avg.make_local_step`` over the
  chunk and issues no collective; its per-replica metrics (a few scalars)
  are averaged by one separate small ``all_reduce`` (``_metrics_mean``,
  the reference's tiny program off the step path);
* the sync (``all_mean``): the fused mean + sqdev kernel in mode
  ``"mean"`` writes every leaf's chunk mean into one flat f32 buffer, the
  all-reduce bucket: one ``all_reduce`` (a sum) for all leaves, then the
  kernel in mode ``"sync_to"`` divides the sum by the world size as it
  reads it, writes the global mean w̄ into every local replica and gives
  Σ_i ||w_i − w̄||² over the chunk, and one scalar ``all_reduce`` gives
  S_k — two collectives a sync (three with ``sync_momentum``, whose
  optimizer-state bucket is one more);
* ``full_step`` and ``qsgd_step``: the chunk's (dequantized) gradient
  sums and its metrics in one flat bucket, one ``all_reduce`` a step
  (the reference's mesh all-reduces QSGD's dequantized f32 gradients
  too);
* ``quantized_all_mean`` is byte-true: each rank quantizes its replicas'
  deltas from the anchor under ``qsgd.replica_keys`` of their global
  indices, and only the int8 levels and the f32 norms cross the wire, in
  one ``all_gather`` of ``n_local × op.payload_bytes(n_params,
  n_leaves)`` bytes a rank; every rank dequantizes all R and reduces them
  exactly as the ``vmap`` backend does (the same ``qsgd.quantize_deltas``
  and ``qsgd.apply_deltas``), so the new anchor and S_k are
  bitwise the ``vmap`` backend's at any world size;
* ``mean_delta`` (DaSGD): the chunk means and a snapshot of the chunk,
  then the bucket's ``all_reduce`` with ``async_op=True``; the call
  returns at once, and ``fetch()`` waits on the work handle (on NCCL that
  orders streams and does not block the host), runs the kernel in mode
  ``"delta_to"`` (dividing the sum as ``"sync_to"`` does) over the
  snapshot in place and all-reduces S_k.  The
  local steps that overlap it never write the snapshot.
* ``inner_mean``: a group inside a rank's chunk is ``avg.group_sync`` on
  the chunk, with no collective; a group of whole ranks all-reduces its
  bucket in one ``dist.new_group`` subgroup per group, created once.

``use_kernel`` follows the ``vmap`` backend's policy (None: the kernels
whenever the parameters are on CUDA; False: the plain versions).  The
reference refuses it on its mesh, whose syncs lower to ``pmean``; here the
sync runs the kernel on the local chunk.  The plain routes are the
``vmap`` backend's (``avg.sync_to`` against the global mean,
``kref.mean_and_sqdev_many_ref`` for DaSGD), so at world 1 every program
is bitwise the ``vmap`` backend's.  Checkpoints stay placement-neutral: the
writer (rank 0) saves the gathered chunks in the reference's format, and
every rank loads its own rows (``gather_replicas`` / ``local_replicas``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.backends.base import ExecutionBackend, register_backend
from repro_torch.backends.ops import Deferred
from repro_torch.configs.base import REPLICA_TP_SLICE
from repro_torch.core import averaging as avg
from repro_torch.core import qsgd as qsgd_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PLACEMENTS = ("replica_ddp", "replica_tp")


def _bucket(shapes: Sequence[torch.Size], device
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One flat f32 buffer and a view of it of each shape, in order."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return flat, [v.view(s) for v, s in zip(flat.split(sizes), shapes)]


@register_backend
class MeshBackend(ExecutionBackend):
    """Replicas over ``torch.distributed`` ranks (``launch/mesh.py``),
    chunk programs on each rank, bucketed collectives."""

    name = "mesh"

    def __init__(self, mesh: Optional[mesh_mod.ReplicaMesh] = None, *,
                 placement: str = "replica_ddp",
                 model_parallel: Optional[int] = None,
                 use_kernel: Optional[bool] = None,
                 device=None):
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement '{placement}'; available: {PLACEMENTS}")
        if placement == "replica_tp" or (model_parallel or 1) != 1:
            raise NotImplementedError(
                f"placement={placement!r} model_parallel={model_parallel}: "
                + REPLICA_TP_SLICE)
        if mesh is None:
            mesh = mesh_mod.make_host_mesh(device=device)
        elif device is not None and torch.device(device).type != \
                mesh.device.type:
            raise ValueError(f"device {device} conflicts with the mesh's "
                             f"{mesh.device}")
        super().__init__(use_kernel=use_kernel, device=mesh.device)
        self.mesh = mesh
        self.placement = placement
        self.replica_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in mesh.shape)
        if not self.replica_axes:
            raise ValueError(
                f"mesh {mesh.axis_names} has no replica axis "
                "('data' or 'pod'); see launch/mesh.py")
        self.n_replica_devices = 1
        for a in self.replica_axes:
            self.n_replica_devices *= mesh.shape[a]
        self.rank, self.world, self.group = mesh.rank, mesh.world, mesh.group
        self._subgroups: Dict[int, object] = {}

    # ------------------------------------------------------------- topology
    def bind(self, n_replicas: int) -> None:
        if n_replicas % self.n_replica_devices:
            raise ValueError(
                f"n_replicas={n_replicas} not divisible by the mesh's "
                f"{self.n_replica_devices} replica devices "
                f"(axes {self.replica_axes} of {self.mesh.shape})")
        super().bind(n_replicas)

    def describe(self):
        return {"backend": self.name, "n_replicas": self.n_replicas,
                "n_devices": self.world, "mesh": dict(self.mesh.shape),
                "placement": self.placement,
                "replica_axes": list(self.replica_axes),
                "rank": self.rank, "device": str(self.device),
                "process_group": self.mesh.backend,
                "use_kernel": self.kernel_policy()}

    def default_group_size(self) -> Optional[int]:
        """Replicas per pod (a node) when there are several pods: inner
        syncs then stay inside a node's NVLink domain."""
        pods = self.mesh.shape.get("pod", 1)
        if pods > 1 and self.n_replicas:
            return max(1, self.n_replicas // pods)
        return None

    def close(self) -> None:
        """Destroy the process group if this backend's mesh created it."""
        self.mesh.close()

    # ------------------------------------------------------------ placement
    def _ids(self) -> range:
        return mesh_mod.replica_range(self.mesh, self.n_replicas)

    def local_replicas(self, tree):
        ids = self._ids()
        return tree_map(lambda x: x[ids.start:ids.stop], tree)

    @torch.no_grad()
    def gather_replicas(self, tree):
        """Every rank's rows of each leaf, gathered leaf by leaf onto the
        host (one leaf at a time on the device)."""
        def leaf(x):
            parts = [torch.empty_like(x) for _ in range(self.world)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts).cpu()
        return tree_map(leaf, tree)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    # ----------------------------------------------------------- internals
    def _div(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """x / n in place, a true division (on the card, dividing by a
        Python number multiplies by its reciprocal)."""
        return x.div_(x.new_tensor(float(n)))

    def _all_mean_(self, x: torch.Tensor, group=None, n: int = 0
                   ) -> torch.Tensor:
        """x averaged over the ranks of ``group`` (n of them), in place."""
        dist.all_reduce(x, group=group or self.group)
        return self._div(x, n or self.world)

    def _global_means(self, leaves, group=None, n: int = 0):
        """Each leaf's f32 mean over the replicas of the ranks of
        ``group`` (n of them; default every rank), as the vmap backend's
        plain routes take a mean (``avg.leaf_means``), in one flat bucket
        and one all-reduce.  Returns the leaves' views of it."""
        flat, views = _bucket([x.shape[1:] for x in leaves], leaves[0].device)
        for v, m in zip(views, avg.leaf_means(leaves)):
            v.copy_(m)
        self._all_mean_(flat, group, n)
        return views

    @staticmethod
    def _write_back(means, leaves) -> None:
        for m, x in zip(means, leaves):
            x.copy_(m.unsqueeze(0).expand_as(x))

    def _metrics_mean(self, metrics: Dict[str, torch.Tensor]):
        """The chunk's metrics averaged over the ranks: one small
        all-reduce of all of them."""
        if not metrics:
            return metrics
        keys = list(metrics)
        flat = torch.cat([metrics[k].detach().to(torch.float32).reshape(-1)
                          for k in keys])
        self._all_mean_(flat)
        out, at = {}, 0
        for k in keys:
            v = metrics[k]
            out[k] = flat[at:at + v.numel()].view(v.shape).to(v.dtype)
            at += v.numel()
        return out

    def _exchange(self, g_sum: List[torch.Tensor],
                  metrics: Dict[str, torch.Tensor]):
        """``avg.Exchange``: the chunk's f32 gradient sums and its metrics
        in one bucket, one all-reduce (sums; the metrics then averaged)."""
        keys = list(metrics)
        shapes = [g.shape for g in g_sum] + [metrics[k].shape for k in keys]
        flat, views = _bucket(shapes, g_sum[0].device)
        for v, x in zip(views, g_sum + [metrics[k] for k in keys]):
            v.copy_(x)
        dist.all_reduce(flat, group=self.group)
        n = len(g_sum)
        out = {}
        for k, v in zip(keys, views[n:]):
            out[k] = self._div(v, self.world).to(metrics[k].dtype)
        return views[:n], out, self.n_replicas

    @torch.no_grad()
    def _opt_mean(self, opt_state):
        """The optimizer state averaged over every replica (f32), written
        back into each local replica: one all-reduce."""
        leaves = tree_leaves(opt_state)
        if leaves:
            self._write_back(self._global_means(leaves), leaves)
        return opt_state

    def _subgroup(self, ranks_per_group: int):
        """This rank's group of ``ranks_per_group`` consecutive ranks.
        Every group is created once, by every rank (``new_group`` is
        collective over the world); groups never cross a pod."""
        grp = self._subgroups.get(ranks_per_group)
        if grp is None:
            axis = self.replica_axes[-1]
            inner = self.mesh.shape[axis]
            if ranks_per_group > inner or inner % ranks_per_group:
                raise NotImplementedError(
                    f"replica groups spanning {ranks_per_group} ranks do "
                    f"not tile the '{axis}' axis (size {inner})")
            for first in range(0, self.world, ranks_per_group):
                g = dist.new_group(
                    list(range(first, first + ranks_per_group)),
                    timeout=mesh_mod.TIMEOUT)
                if first <= self.rank < first + ranks_per_group:
                    grp = g
            self._subgroups[ranks_per_group] = grp
        return grp

    # ------------------------------------------------------------ lowerings
    def _lower_replica_step(self, op, *, loss_fn, optimizer):
        local = avg.make_local_step(loss_fn, optimizer)

        def step(W, opt_state, batch, lr):
            W, opt_state, metrics = local(W, opt_state, batch, lr)
            return W, opt_state, self._metrics_mean(metrics)

        return step

    def _lower_full_step(self, op, *, loss_fn, optimizer):
        return avg.make_full_step(loss_fn, optimizer, exchange=self._exchange)

    def _lower_qsgd_step(self, op, *, loss_fn, optimizer):
        return qsgd_mod.make_qsgd_step(
            loss_fn, optimizer, op.wire.bits,
            use_kernel=self.use_kernel is not False,
            replica_ids=self._ids(), exchange=self._exchange)

    def _lower_all_mean(self, op, *, sync_momentum=False):
        @torch.no_grad()
        def all_mean(W, opt_state):
            leaves = tree_leaves(W)
            if self.kernel_on(W):
                mean, _ = kops.param_mean_and_sqdev_out(leaves, "mean")
                kops.param_mean_and_sqdev_many(leaves, "mean", mean)
                dist.all_reduce(mean, group=self.group)
                _, s_loc = kops.param_mean_and_sqdev_many(
                    leaves, "sync_to", None, mean, self.world)
            else:
                s_loc = avg.sync_to(leaves, self._global_means(leaves))
            s_k = self._all_mean_(s_loc.reshape(1).clone())[0]
            if opt_state is not None and sync_momentum:
                opt_state = self._opt_mean(opt_state)
            return W, opt_state, s_k

        return all_mean

    def _lower_opt_mean(self, op):
        return self._opt_mean

    def _lower_inner_mean(self, op):
        g = int(op.group)

        @torch.no_grad()
        def inner(W):
            r_local = self.n_local
            if r_local % g == 0:
                # groups fall inside this rank's chunk: no collective
                return avg.group_sync(W, g)
            if g % r_local:
                raise NotImplementedError(
                    f"group_size={g} does not align with {r_local} local "
                    f"replicas per rank")
            k = g // r_local
            leaves = tree_leaves(W)
            self._write_back(self._global_means(leaves, self._subgroup(k), k),
                             leaves)
            return W

        return inner

    def _lower_quantized_all_mean(self, op):
        """The byte-true exchange.  This rank's payload is one int8 buffer:
        the norms of its replicas (``n_local × L`` f32, as bytes), then
        their levels, replica by replica, leaf by leaf; one ``all_gather``
        of it; every rank then dequantizes all R replicas leaf by leaf and
        reduces them as ``VmapBackend._lower_quantized_all_mean`` does,
        with the same two halves (``qsgd.quantize_deltas``,
        ``qsgd.apply_deltas``)."""
        bits = op.wire.bits
        kernel = self.use_kernel is not False

        @torch.no_grad()
        def qsync(W, anchor, key):
            leaves, anchors = tree_leaves(W), tree_leaves(anchor)
            L, R, r_local = len(leaves), self.n_replicas, self.n_local
            sizes = [a.numel() for a in anchors]
            n = sum(sizes)
            head = 4 * r_local * L
            span = head + r_local * n
            device = leaves[0].device
            payload = torch.empty(span, dtype=torch.int8, device=device)
            norms = torch.empty((r_local, L), dtype=torch.float32,
                                device=device)
            levels = payload[head:].view(r_local, n)
            keys = qsgd_mod.delta_keys(key, self._ids(), L)
            at = 0
            for i, (w, a) in enumerate(zip(leaves, anchors)):
                for j, lv, nm in qsgd_mod.quantize_deltas(
                        w, a, keys, i, bits, use_kernel=kernel):
                    levels[j, at:at + sizes[i]].copy_(lv.reshape(-1))
                    norms[j, i] = nm
                at += sizes[i]
            payload[:head].copy_(norms.view(-1).view(torch.int8))
            del norms
            gathered = torch.empty(self.world * span, dtype=torch.int8,
                                   device=device)
            dist.all_gather(list(gathered.view(self.world, span)), payload,
                            group=self.group)
            del payload
            chunks = gathered.view(self.world, span)
            all_norms = chunks[:, :head].clone().view(torch.float32).view(R, L)

            def level_row(r: int) -> torch.Tensor:
                return chunks[r // r_local, head:].view(r_local, n)[r % r_local]
            s_k, at = 0, 0
            for i, (w, a) in enumerate(zip(leaves, anchors)):
                dq = torch.empty((R,) + tuple(a.shape), dtype=torch.float32,
                                 device=device)
                for r in range(R):
                    lv = level_row(r)[at:at + sizes[i]].view(a.shape)
                    dq[r] = qsgd_mod.dequantize(lv, all_norms[r, i], bits,
                                                use_kernel=kernel)
                s_k = s_k + qsgd_mod.apply_deltas(w, a, dq,
                                                  use_kernel=kernel) / R
                del dq
                at += sizes[i]
            return W, anchor, s_k

        return qsync

    def _lower_mean_delta(self, op):
        """DaSGD's snapshot, dispatched without waiting: the chunk means
        into the bucket (the kernel's mode "mean", or its plain version)
        and a copy of the chunk into the delta buffer, both queued on W's
        stream before the next step writes W; the bucket's all-reduce (a
        sum) in flight.  ``fetch()`` waits for it and turns the copy into
        ``w̄ − w_i`` in place (mode "delta_to", the sum divided by the
        world size), with S_k from one more all-reduce.  Returns a ``Deferred`` of (delta
        tree, S_k)."""

        @torch.no_grad()
        def mean_delta(W):
            leaves = tree_leaves(W)
            kernel = self.kernel_on(W)
            if kernel:
                mean, means = kops.param_mean_and_sqdev_out(leaves, "mean")
                kops.param_mean_and_sqdev_many(leaves, "mean", mean)
                snap, snaps = kops.param_mean_and_sqdev_out(leaves,
                                                            "delta_to")
                for s, x in zip(snaps, leaves):
                    s.copy_(x)
            else:
                snaps = [x.to(torch.float32).clone() for x in leaves]
                mean, means = _bucket([x.shape[1:] for x in leaves],
                                      leaves[0].device)
                kref.mean_and_sqdev_many_ref(snaps, "mean", means)
                snap = None
            work = dist.all_reduce(mean, group=self.group, async_op=True)

            def finish():
                work.wait()
                if kernel:
                    _, s_loc = kops.param_mean_and_sqdev_many(
                        snaps, "delta_to", snap, mean, self.world)
                else:
                    _, s_loc = kref.mean_and_sqdev_many_ref(
                        snaps, "delta_to", snaps, means, self.world)
                s_k = self._all_mean_(s_loc.reshape(1).clone())[0]
                return tree_unflatten(W, snaps), s_k

            return Deferred(finish)

        return mean_delta

    # ------------------------------------------------------------- helpers
    @torch.no_grad()
    def collapse(self, W):
        """The mean over every replica (each leaf in its dtype): one
        all-reduce."""
        leaves = tree_leaves(W)
        flat, means = _bucket([x.shape[1:] for x in leaves], leaves[0].device)
        for m, x in zip(means, leaves):
            m.copy_(x.mean(dim=0))
        self._all_mean_(flat)
        return tree_unflatten(W, [m.to(x.dtype)
                                  for m, x in zip(means, leaves)])

    @torch.no_grad()
    def parameter_variance(self, W) -> torch.Tensor:
        """Var[W_k] over every replica: the global mean (one all-reduce),
        the chunk's squared deviations from it, one scalar all-reduce."""
        leaves = tree_leaves(W)
        s = avg.sync_to(leaves, self._global_means(leaves), write=False)
        return self._all_mean_(s.reshape(1).clone())[0]
