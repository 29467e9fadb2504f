"""Multi-GPU backend: the replica axis over processes on
``torch.distributed`` (port of ``repro/backends/mesh.py``).

One process per GPU, NCCL between the GPUs (gloo between CPU processes,
with ``device="cpu"``).  The ranks form a ``(data, model)`` mesh
(``launch/mesh.py``).  Each of the ``n_data`` data indices holds a
contiguous chunk of ``n_local = R / n_data`` replicas, global indices
``i·n_local … (i+1)·n_local − 1``, stacked on dim 0 of every leaf as on
the ``vmap`` backend.  Two placements decide what one replica is:

* ``replica_ddp`` (default): a whole model; the model axis is 1 (every
  rank a data index), or larger with every model rank holding the same
  whole replicas.
* ``replica_tp``: one replica spans the ``model`` axis of m ranks.  Each
  rank stores its shard of every leaf, cut by ``launch/sharding.py``'s
  megatron rules (column- and row-parallel matmuls, vocab-parallel
  embeddings, expert-parallel MoE, replicated where m does not divide a
  dim); the local step runs each replica's forward and backward on
  DTensors over the model group (``backends/tp.py``).  The replica mean is
  elementwise, so every sync below runs on the shards over the data group
  alone; S_k sums each element once (a leaf held whole by every model
  rank enters model index 0's sum alone) with one all-reduce over the
  world.  ``quantized_all_mean`` and the QSGD step make leaves whole over
  the model group first (each leaf's norm and uniforms are the whole
  leaf's), as the reference does in its fully manual region.

The strategies' syncs become real collectives over the data group, and
their number does not depend on the number of leaves:

* the local step (``replica_step``) is ``avg.make_local_step`` over the
  chunk and issues no collective over the data group (under
  ``replica_tp``, DTensor's collectives and each replica's gradient norm
  run over the model group); its per-replica metrics (a few scalars)
  are averaged by one separate small ``all_reduce`` (``_metrics_mean``,
  the reference's tiny program off the step path);
* the sync (``all_mean``): the fused mean + sqdev kernel in mode
  ``"mean"`` writes every leaf's chunk mean into one flat f32 buffer, the
  all-reduce bucket: one ``all_reduce`` (a sum) for all leaves, then the
  kernel in mode ``"sync_to"`` divides the sum by the data size as it
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
  the chunk, with no collective; a group of whole data indices
  all-reduces its bucket in one ``dist.new_group`` subgroup of the data
  axis per group and model index, created once.

``use_kernel`` follows the ``vmap`` backend's policy (None: the kernels
whenever the parameters are on CUDA; False: the plain versions).  The
reference refuses it on its mesh, whose syncs lower to ``pmean``; here the
sync runs the kernel on the local chunk.  The plain routes are the
``vmap`` backend's (``avg.sync_to`` against the global mean,
``kref.mean_and_sqdev_many_ref`` for DaSGD), so at world 1 every program
is bitwise the ``vmap`` backend's, under either placement.  Checkpoints
stay placement-neutral: ``gather_replicas`` makes each leaf whole over the
model group, then gathers the data chunks, and the writer (rank 0) saves
them in the reference's format; every rank loads its own rows
(``local_replicas``) and ``put_params`` / ``put_opt`` cut its shard.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.backends import tp as tp_mod
from repro_torch.backends.base import ExecutionBackend, register_backend
from repro_torch.backends.ops import Deferred
from repro_torch.configs.base import ModelConfig, ParallelismPlan
from repro_torch.core import averaging as avg
from repro_torch.core import qsgd as qsgd_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as shard_rules
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
                 model_cfg: Optional[ModelConfig] = None,
                 placement: str = "replica_ddp",
                 model_parallel: Optional[int] = None,
                 use_kernel: Optional[bool] = None,
                 device=None):
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement '{placement}'; available: {PLACEMENTS}")
        if mesh is None:
            if model_parallel is None:
                # replica_tp wants a model axis when the world allows one;
                # replica_ddp keeps every rank a data index
                n = (dist.get_world_size() if dist.is_initialized()
                     else mesh_mod._env_int("WORLD_SIZE", 1))
                model_parallel = 2 if (placement == "replica_tp"
                                       and n > 1 and n % 2 == 0) else 1
            mesh = mesh_mod.make_host_mesh(model_parallel, device=device)
        elif device is not None and torch.device(device).type != \
                mesh.device.type:
            raise ValueError(f"device {device} conflicts with the mesh's "
                             f"{mesh.device}")
        if placement == "replica_tp" and "model" not in mesh.shape:
            raise ValueError(
                f"placement 'replica_tp' needs a 'model' mesh axis, "
                f"got {mesh.axis_names}")
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
        self.rank, self.world = mesh.rank, mesh.world
        self.m = mesh.model_size
        # the syncs' group (every data index of this rank's model index)
        # and its size
        self.group, self.n_data = mesh.data_group, self.n_replica_devices
        self.tp = placement == "replica_tp"
        self._model_cfg = model_cfg or ModelConfig()
        self._plan = ParallelismPlan(plan="replica_dp", placement=placement)
        self._layout = tp_mod.Layout(self.m, mesh.model_index)
        self._pspecs = None            # the stacked params' spec tree
        self._subgroups: Dict[int, object] = {}
        # the torch functions the local steps ran on whole operands
        # (backends/tp.py's WholeWhereRefused), by name
        self.whole: Counter = Counter()

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
                "placement": self.placement, "model_parallel": self.m,
                "replica_axes": list(self.replica_axes),
                "rank": self.rank, "device": str(self.device),
                "process_group": self.mesh.backend,
                "use_kernel": self.kernel_policy(),
                **({"whole": dict(self.whole)} if self.tp else {})}

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
    @property
    def n_local(self) -> int:
        """Replicas this rank holds (those of its data index)."""
        return (self.n_replicas or 1) // self.n_replica_devices

    def _ids(self) -> range:
        return mesh_mod.replica_range(self.mesh, self.n_replicas)

    def local_replicas(self, tree):
        """This rank's rows: its data index's (the batch is replicated over
        the model axis)."""
        ids = self._ids()
        return tree_map(lambda x: x[ids.start:ids.stop], tree)

    def _dims(self, tree) -> List[Optional[int]]:
        """The model-sharded dim of each stacked leaf (None: whole)."""
        if not self.tp:
            return [None] * len(tree_leaves(tree))
        return self._layout.dims_of(tree)

    def _cut(self, tree):
        """This rank's shard of each whole stacked leaf (contiguous; the
        leaf itself where it is held whole)."""
        return tree_unflatten(tree, [
            self._layout.cut(x, d).contiguous()
            for x, d in zip(tree_leaves(tree), self._dims(tree))])

    def _param_specs(self, W):
        specs = shard_rules.param_specs(
            self._model_cfg, W, self.mesh, self._plan,
            replica_axes=self.replica_axes, stacked=True)
        self._layout.record(specs)
        self._pspecs = specs

    def _opt_specs(self, opt_state):
        self._layout.record(shard_rules.opt_specs(
            self._model_cfg, opt_state, self._pspecs, self.mesh, self._plan,
            replica_axes=self.replica_axes, stacked=True))

    def stack_params(self, params0):
        if not self.tp:
            return super().stack_params(params0)
        n = self.n_local
        self._param_specs(tree_map(lambda x: torch.empty(
            (n,) + tuple(x.shape), dtype=x.dtype, device="meta"), params0))
        shards = [self._layout.cut(x.to(self.device), d - 1)
                  if d is not None else x.to(self.device)
                  for x, d in zip(tree_leaves(params0),
                                  self._layout.dims_of(params0))]
        return avg.stack_replicas(tree_unflatten(params0, shards), n)

    def put_params(self, W):
        """Whole stacked leaves (this rank's rows) -> its shards."""
        W = super().put_params(W)
        if not self.tp:
            return W
        self._param_specs(W)
        return self._cut(W)

    def put_opt(self, opt_state, W):
        """Whole stacked optimizer state -> its shards (the specs of the
        parameter each buffer mirrors; step counters whole)."""
        opt_state = super().put_opt(opt_state, W)
        if not self.tp or not tree_leaves(opt_state):
            return opt_state
        self._opt_specs(opt_state)
        return self._cut(opt_state)

    def init_opt_state(self, optimizer, W):
        """The optimizer's state of this rank's shards (already cut)."""
        opt_state = optimizer.init(W, n_replicas=avg.n_replicas(W))
        if self.tp and tree_leaves(opt_state):
            self._opt_specs(opt_state)
        return opt_state

    def whole_shapes(self, tree):
        if not self.tp:
            return super().whole_shapes(tree)
        return self._layout.whole_shapes(tree)

    @torch.no_grad()
    def gather_replicas(self, tree):
        """Every rank's rows of each leaf, made whole over the model group
        and gathered over the data group, leaf by leaf onto the host (one
        leaf at a time on the device)."""
        def leaf(x, d):
            if d is not None:
                x = tp_mod.gather_model([x], [d], self.m,
                                        self.mesh.model_group)[0]
            parts = [torch.empty_like(x) for _ in range(self.n_data)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts).cpu()
        return tree_unflatten(tree, [leaf(x, d) for x, d in zip(
            tree_leaves(tree), self._dims(tree))])

    def rank_bytes(self, tree) -> List[int]:
        """The bytes of a tree each rank holds (its rows, its shards), by
        rank: one ``all_gather_object`` over the world."""
        got: List[int] = [0] * self.world
        dist.all_gather_object(got, super().rank_bytes(tree)[0],
                               group=self.mesh.group)
        return got

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.group)

    # ----------------------------------------------------------- internals
    def _shards(self):
        """The local step's tensor-parallel hooks (None: whole replicas)."""
        if not self.tp:
            return None
        return tp_mod.ModelShards(self._layout, self.mesh.model_mesh,
                                  self.mesh.model_group, self.whole)

    def _count(self, W) -> Optional[List[bool]]:
        """Which leaves enter this rank's share of S_k: every leaf on
        model index 0 (None); elsewhere the sharded leaves alone."""
        if self.mesh.model_index == 0:
            return None
        return [d is not None for d in self._dims(W)]

    @staticmethod
    def _counted(sq: torch.Tensor, count, R: int, s_all: torch.Tensor):
        """S over the counted leaves from the kernel's per-leaf sums."""
        if count is None:
            return s_all
        mask = torch.tensor(count, dtype=torch.bool, device=sq.device)
        return sq[mask].sum() / R

    def _world_mean(self, s_loc: torch.Tensor) -> torch.Tensor:
        """S_k from each rank's share: one all-reduce over the world (the
        data and the model ranks), divided by the data size."""
        x = s_loc.reshape(1).to(torch.float32).clone()
        dist.all_reduce(x, group=self.mesh.group)
        return self._div(x, self.n_data)[0]

    def _div(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """x / n in place, a true division (on the card, dividing by a
        Python number multiplies by its reciprocal)."""
        return x.div_(x.new_tensor(float(n)))

    def _all_mean_(self, x: torch.Tensor, group=None, n: int = 0
                   ) -> torch.Tensor:
        """x averaged over the ranks of ``group`` (n of them; default the
        data group), in place."""
        dist.all_reduce(x, group=group or self.group)
        return self._div(x, n or self.n_data)

    def _global_means(self, leaves, group=None, n: int = 0):
        """Each leaf's f32 mean over the replicas of the ranks of
        ``group`` (n of them; default the data group), as the vmap
        backend's plain routes take a mean (``avg.leaf_means``), in one
        flat bucket and one all-reduce.  Returns the leaves' views of
        it."""
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
        """The chunk's metrics averaged over the data group: one small
        all-reduce of all of them (every model rank holds them whole)."""
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
        """``avg.Exchange``: the chunk's f32 gradient sums (shards) and its
        metrics in one bucket, one all-reduce over the data group (sums;
        the metrics then averaged)."""
        keys = list(metrics)
        shapes = [g.shape for g in g_sum] + [metrics[k].shape for k in keys]
        flat, views = _bucket(shapes, g_sum[0].device)
        for v, x in zip(views, g_sum + [metrics[k] for k in keys]):
            v.copy_(x)
        dist.all_reduce(flat, group=self.group)
        n = len(g_sum)
        out = {}
        for k, v in zip(keys, views[n:]):
            out[k] = self._div(v, self.n_data).to(metrics[k].dtype)
        return views[:n], out, self.n_replicas

    @torch.no_grad()
    def _opt_mean(self, opt_state):
        """The optimizer state averaged over every replica (f32), written
        back into each local replica: one all-reduce."""
        leaves = tree_leaves(opt_state)
        if leaves:
            self._write_back(self._global_means(leaves), leaves)
        return opt_state

    def _subgroup(self, per_group: int):
        """This rank's group of ``per_group`` consecutive data indices (of
        its model index).  Every group is created once, by every rank
        (``new_group`` is collective over the world), one set per model
        index; groups never cross a pod."""
        grp = self._subgroups.get(per_group)
        if grp is None:
            axis = self.replica_axes[-1]
            inner = self.mesh.shape[axis]
            if per_group > inner or inner % per_group:
                raise NotImplementedError(
                    f"replica groups spanning {per_group} ranks do "
                    f"not tile the '{axis}' axis (size {inner})")
            for first in range(0, self.n_data, per_group):
                for mi in range(self.m):
                    ranks = [(first + j) * self.m + mi
                             for j in range(per_group)]
                    g = dist.new_group(ranks, timeout=mesh_mod.TIMEOUT)
                    if self.rank in ranks:
                        grp = g
            self._subgroups[per_group] = grp
        return grp

    # ------------------------------------------------------------ lowerings
    def _lower_replica_step(self, op, *, loss_fn, optimizer):
        local = avg.make_local_step(loss_fn, optimizer, tp=self._shards())

        def step(W, opt_state, batch, lr):
            W, opt_state, metrics = local(W, opt_state, batch, lr)
            return W, opt_state, self._metrics_mean(metrics)

        return step

    def _lower_full_step(self, op, *, loss_fn, optimizer):
        return avg.make_full_step(loss_fn, optimizer, exchange=self._exchange,
                                  tp=self._shards())

    def _lower_qsgd_step(self, op, *, loss_fn, optimizer):
        return qsgd_mod.make_qsgd_step(
            loss_fn, optimizer, op.wire.bits,
            use_kernel=self.use_kernel is not False,
            replica_ids=self._ids(), exchange=self._exchange,
            tp=self._shards())

    def _lower_all_mean(self, op, *, sync_momentum=False):
        @torch.no_grad()
        def all_mean(W, opt_state):
            leaves = tree_leaves(W)
            count = self._count(W)
            if self.kernel_on(W):
                mean, _ = kops.param_mean_and_sqdev_out(leaves, "mean")
                kops.param_mean_and_sqdev_many(leaves, "mean", mean)
                dist.all_reduce(mean, group=self.group)
                sq, s_loc = kops.param_mean_and_sqdev_many(
                    leaves, "sync_to", None, mean, self.n_data)
                s_loc = self._counted(sq, count, self.n_local, s_loc)
            else:
                s_loc = avg.sync_to(leaves, self._global_means(leaves),
                                    count=count)
            s_k = self._world_mean(s_loc)
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
        """The byte-true exchange.  Under ``replica_tp`` the leaves are
        made whole over the model group first (one bucketed all-gather)
        and each rank keeps its shard of the result.  This rank's payload
        is one int8 buffer: the norms of its replicas (``n_local × L``
        f32, as bytes), then their levels, replica by replica, leaf by
        leaf; one ``all_gather`` of it over the data group; every rank
        then dequantizes all R replicas leaf by leaf and reduces them as
        ``VmapBackend._lower_quantized_all_mean`` does, with the same two
        halves (``qsgd.quantize_deltas``, ``qsgd.apply_deltas``)."""
        bits = op.wire.bits
        kernel = self.use_kernel is not False
        shards = self._shards()

        @torch.no_grad()
        def qsync(W, anchor, key):
            local, anchors = tree_leaves(W), tree_leaves(anchor)
            leaves = (local if shards is None
                      else shards.bind(W).whole(local, stacked=True))
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
            gathered = torch.empty(self.n_data * span, dtype=torch.int8,
                                   device=device)
            dist.all_gather(list(gathered.view(self.n_data, span)), payload,
                            group=self.group)
            del payload
            chunks = gathered.view(self.n_data, span)
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
            if leaves is not local:
                for x, w, d in zip(local, leaves, self._dims(W)):
                    if w is not x:
                        x.copy_(self._layout.cut(w, d))
            return W, anchor, s_k

        return qsync

    def _lower_mean_delta(self, op):
        """DaSGD's snapshot, dispatched without waiting: the chunk means
        into the bucket (the kernel's mode "mean", or its plain version)
        and a copy of the chunk into the delta buffer, both queued on W's
        stream before the next step writes W; the bucket's all-reduce (a
        sum, over the data group) in flight.  ``fetch()`` waits for it and
        turns the copy into ``w̄ − w_i`` in place (mode "delta_to", the sum
        divided by the data size), with S_k from one more all-reduce.
        Returns a ``Deferred`` of (delta tree, S_k)."""

        @torch.no_grad()
        def mean_delta(W):
            leaves = tree_leaves(W)
            count = self._count(W)
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
                    sq, s_loc = kops.param_mean_and_sqdev_many(
                        snaps, "delta_to", snap, mean, self.n_data)
                else:
                    sq, s_loc = kref.mean_and_sqdev_many_ref(
                        snaps, "delta_to", snaps, means, self.n_data)
                s_loc = self._counted(sq, count, len(leaves[0]), s_loc)
                return tree_unflatten(W, snaps), self._world_mean(s_loc)

            return Deferred(finish)

        return mean_delta

    # ------------------------------------------------------------- helpers
    @torch.no_grad()
    def collapse(self, W):
        """The mean over every replica (each leaf in its dtype, whole): one
        all-reduce over the data group, then the shards made whole over
        the model group."""
        leaves = tree_leaves(W)
        flat, means = _bucket([x.shape[1:] for x in leaves], leaves[0].device)
        for m, x in zip(means, leaves):
            m.copy_(x.mean(dim=0))
        self._all_mean_(flat)
        means = tp_mod.gather_model(
            means, [None if d is None else d - 1 for d in self._dims(W)],
            self.m, self.mesh.model_group)
        return tree_unflatten(W, [m.to(x.dtype)
                                  for m, x in zip(means, leaves)])

    @torch.no_grad()
    def parameter_variance(self, W) -> torch.Tensor:
        """Var[W_k] over every replica: the global mean (one all-reduce),
        the chunk's squared deviations from it, one scalar all-reduce."""
        leaves = tree_leaves(W)
        s = avg.sync_to(leaves, self._global_means(leaves), write=False,
                        count=self._count(W))
        return self._world_mean(s)
