"""Dry run of every (architecture x input shape) pair on a production-size
mesh, in one process and without a GPU (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The mesh is ``launch/mesh.py::make_dryrun_mesh``: 32 x 8 GPUs (data x
model; 2 x 32 x 8 with ``--multi-pod``) as rank 0 of a group on torch's
``fake`` backend, every tensor on the meta device.  Per pair it builds
and runs the programs the shape's kind dictates, the way the port runs
them:

  train_4k     -> local_step, full_step, sync_step
  prefill_32k  -> prefill_step
  decode_*     -> serve_step (one token against full caches / states)

A ``replica_dp`` / ``replica_ddp`` plan trains on the mesh backend
(``backends/mesh.py``, placement ``replica_tp``): rank 0's replicas, each
spread over the model group on DTensors (``backends/tp.py``).  An
``fsdp`` plan (Mixtral, Jamba) trains on DTensors over the whole
(data, model) mesh, placed by ``launch/sharding.py``'s specs; like the
reference's, that program exists only here.  Serving runs every plan on
DTensors over the whole mesh.

``analyze`` takes the place of XLA's compiled analyses.  ``CostMode``, a
dispatch mode, sees every aten op a rank runs on its local tensors
(DTensor ops are left to DTensor, which runs them as local ops): FLOPs by
``FlopCounterMode``'s formulas, bytes as each op's inputs read and outputs
written (eager PyTorch runs unfused, so this is its traffic), the live
bytes of the tensors the program creates (their peak, with the
temporaries of ``_WORKSPACE``'s kernels), the collectives
(DTensor's functional ones and the backend's own c10d calls) priced with
the reference's ring factors by type and by mesh axis, and each kernel
call's bytes and operations (``kernels/cost.py``; the kernels do not
run on meta).  Counts are per GPU, as ``flops_per_chip`` means.

Two rooflines come of the counts.  ``roofline`` prices
``hbm_bytes_per_chip``, the traffic of this implementation's eager ops,
unfused: it moves whenever the implementation does (a fused kernel
lowers it), so it is no yardstick for a speed-up.  ``roofline_io``
prices ``io_bytes_per_chip`` instead, the least traffic of the program:
each argument it reads, read once, each it writes, written once, and
each new result written once.  That does not depend on how the program
is written, and its ``bound_s`` is the denominator of a step's roofline
share.

``--no-correction`` builds every program at full depth.  By default a
train or prefill program of a config with a ``scan_grouping`` is built
at two cut depths and its counts extrapolated affinely to full depth, as
the reference corrects XLA's scan; the port counts every op, so here the
correction only saves time.  Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.comm_model import roofline_terms
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import (make_dryrun_mesh, n_replicas_for,
                                     replica_axes_for)
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = [
    "qwen2-vl-2b", "xlstm-350m", "whisper-medium", "qwen2.5-14b", "olmo-1b",
    "glm4-9b", "mixtral-8x22b", "jamba-1.5-large-398b",
    "deepseek-v2-lite-16b", "minicpm-2b",
]

# long_500k needs sub-quadratic attention (the reference's DESIGN.md §5)
LONG_OK = {"xlstm-350m", "jamba-1.5-large-398b", "mixtral-8x22b"}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MESH = {"data": 32, "model": 8}
MULTI_POD_MESH = {"pod": 2, "data": 32, "model": 8}
LR = 1e-3
TOP = 8          # the ops a record lists by FLOPs and by bytes

# bytes each participant moves per byte of the op's result (ring
# algorithms; the reference's dryrun.py:89-93)
RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n,
        "all-gather": lambda n: (n - 1) / n,
        "reduce-scatter": lambda n: float(n - 1),
        "all-to-all": lambda n: (n - 1) / n,
        "collective-permute": lambda n: 1.0}


def collective_bytes(calls) -> Dict[str, Any]:
    """Per-GPU collective traffic from (op, result bytes, group size,
    axis) calls, priced with the ring factors.  A group of one moves
    nothing and is not counted."""
    by_type: Dict[str, float] = {}
    count: Dict[str, int] = {}
    by_axis: Dict[str, float] = {}
    count_axis: Dict[str, int] = {}
    for op, nbytes, n, axis in calls:
        if n <= 1:
            continue
        b = nbytes * RING[op](n)
        by_type[op] = by_type.get(op, 0.0) + b
        count[op] = count.get(op, 0) + 1
        by_axis[axis] = by_axis.get(axis, 0.0) + b
        count_axis[axis] = count_axis.get(axis, 0) + 1
    return {"bytes_by_type": by_type, "count_by_type": count,
            "bytes_by_axis": by_axis, "count_by_axis": count_axis,
            "total_bytes": sum(by_type.values())}


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# metadata queries: FlopCounterMode leaves them alone too
_METADATA = {_aten.is_contiguous.default, _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default, _aten.size.default,
             _aten.sym_size.default, _aten.stride.default,
             _aten.sym_stride.default, _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}
# ops that allocate without writing, or alias: no bytes moved
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh", "set_"}
# ops whose CUDA kernels allocate a temporary the size of their first
# argument and free it before they return, which no dispatch shows:
# ATen's softmax_backward_cuda_out computes ``grad * output`` first,
# logsumexp_out_impl ``self - amax(self)``.  On the H100 each raised
# ``max_memory_allocated`` by exactly that (chip_smoke.py phase 17).
# Other kernels' internal workspaces (cuBLAS's, cuDNN's, NCCL's) are not
# modelled
_WORKSPACE = {"_softmax_backward_data", "logsumexp"}
# (namespace, op name) -> the reference's collective name
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "collective-permute",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "broadcast_"): "collective-permute",
}
_FUNCOL_NOOP = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(x) -> List[torch.Tensor]:
    import torch.utils._pytree as pytree
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts what one process runs while it is active (see the module's
    docstring).  ``axis_of`` names the mesh axis of each process group by
    its group name; ``known`` are tensors that exist before the program
    (its arguments), whose storage is never counted as the program's."""

    def __init__(self, axis_of: Optional[Dict[str, str]] = None,
                 known=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._registry = FlopCounterMode(display=False).flop_registry
        self.axis_of = dict(axis_of or {})
        self.flops = 0
        self.bytes = 0
        self.calls: List[Tuple[str, int, int, str]] = []
        # the backend's own torch.distributed calls: (op, bytes, axis)
        self.c10d_calls: List[Tuple[str, int, str]] = []
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._seen = set()
        # the arguments' storages, held so that their ids stay theirs
        self._known_storages = [t.untyped_storage() for t in known]
        self._known = {id(s) for s in self._known_storages}
        # the bytes of the arguments on each storage (an argument may be a
        # view of a larger one: a rank's rows of the stacked replicas)
        self._arg_bytes: Counter = Counter()
        for t in {id(t): t for t in known}.values():
            self._arg_bytes[id(t.untyped_storage())] += \
                t.numel() * t.element_size()
        # the arguments' storages the program read and wrote: id -> bytes
        self.read: Dict[int, int] = {}
        self.written: Dict[int, int] = {}

    def is_known(self, t: torch.Tensor) -> bool:
        return id(t.untyped_storage()) in self._known

    def _touch(self, tensors, into: Dict[int, int]) -> None:
        """Mark the arguments' storages among ``tensors`` in ``into``."""
        for t in tensors:
            s = t.untyped_storage()
            if id(s) in self._known:
                into[id(s)] = min(self._arg_bytes[id(s)], s.nbytes())

    # ------------------------------------------------------------ kernels
    def record_kernel(self, name: str, n_bytes: float, n_ops: float,
                      reads=(), writes=()) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "ops": 0.0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        k["ops"] += n_ops
        self._touch(reads, self.read)
        self._touch(writes, self.written)

    # ------------------------------------------------------------- memory
    def _track(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            key = id(s)
            if key in self._seen or key in self._known:
                continue
            n = s.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    # -------------------------------------------------------- collectives
    def _collective(self, func, args, kwargs, out) -> None:
        names = [a.name for a in func._schema.arguments]
        bound = dict(zip(names, args), **kwargs)
        op = _COLLECTIVES[(func.namespace, func._schema.name.split("::")[1])]
        if func.namespace == "c10d":
            pg = dist.ProcessGroup.unbox(bound["process_group"])
            n, name = pg.size(), pg.group_name
            result = [t for k in ("tensors", "output_tensors",
                                  "output_tensor", "output")
                      if k in bound for t in _tensors(bound[k])]
        else:
            name = bound["group_name"]
            n = dist.distributed_c10d._get_group_size_by_name(name)
            result = _tensors(out)
        nbytes = sum(t.numel() * t.element_size() for t in result)
        # a group of this rank alone (a one-pod fsdp sync's) moves nothing
        axis = self.axis_of.get(name, "self" if n == 1 else name)
        self.calls.append((op, nbytes, n, axis))
        if func.namespace == "c10d":
            self.c10d_calls.append((op, nbytes, axis))

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs it as local ops
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)    # DTensor's shape propagation
        packet = func._overloadpacket
        if not func.is_view and \
                func._schema.name.split("::")[1] not in _NO_TRAFFIC:
            self._touch(_tensors((args, kwargs)), self.read)
            self._touch(_mutated(func, args, kwargs), self.written)
        if func.namespace in ("_c10d_functional", "c10d"):
            out = func(*args, **kwargs)
            if func._schema.name.split("::")[1] not in _FUNCOL_NOOP:
                self._collective(func, args, kwargs, out)
            return out
        if packet not in self._registry and \
                func is not torch.ops.prim.device.default:
            with self:                      # as FlopCounterMode does
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[1]
        if packet in self._registry:
            n = self._registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[name] += n
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = {id(t): t for t in _tensors((args, kwargs))}
            n = sum(t.numel() * t.element_size() for t in ins.values()) + \
                sum(t.numel() * t.element_size() for t in _tensors(out))
            self.bytes += n
            self.bytes_by_op[name] += n
        if not func.is_view:
            self._track(out)
        if name in _WORKSPACE:
            t = args[0]
            self.peak = max(self.peak,
                            self.live + t.numel() * t.element_size())
        return out


def _mutated(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place (its schema's ``(a!)``
    arguments, ``out=`` among them)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors as this process holds them (a DTensor's
    local shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def analyze(fn: Callable, args, *, n_chips: int = 1,
            axis_of: Optional[Dict[str, str]] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` under a ``CostMode``; returns (its outputs, the
    record: per-GPU FLOPs, bytes, collectives, kernel calls, memory and
    the roofline terms over ``n_chips``)."""
    known = [_local(t) for t in tree_leaves(args)
             if isinstance(t, torch.Tensor)]
    mode = CostMode(axis_of, known)
    t0 = time.perf_counter()
    with mode:
        out = fn(*args)
    build_s = time.perf_counter() - t0
    arg_bytes = tree_bytes(args)
    coll = collective_bytes(mode.calls)
    coll["c10d_calls"] = [list(c) for c in mode.c10d_calls]
    flops = mode.flops + sum(k["ops"] for k in mode.kernels.values())
    hbm = mode.bytes + sum(k["bytes"] for k in mode.kernels.values())
    out_bytes = sum(_local(t).numel() * _local(t).element_size()
                    for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)
                    and not mode.is_known(_local(t)))
    io = sum(mode.read.values()) + sum(mode.written.values()) + out_bytes
    rec = {
        "flops_per_chip": float(flops),
        "hbm_bytes_per_chip": float(hbm),
        "io_bytes_per_chip": float(io),
        "collective_bytes_per_chip": coll["total_bytes"],
        "collectives": coll,
        "aten_flops_per_chip": float(mode.flops),
        "top_ops": {"flops": dict(mode.flops_by_op.most_common(TOP)),
                    "bytes": dict(mode.bytes_by_op.most_common(TOP))},
        "kernels": mode.kernels,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": out_bytes,
                   "temp_bytes": mode.peak,
                   "peak_bytes": arg_bytes + mode.peak},
        "roofline": roofline_terms(flops * n_chips, hbm * n_chips,
                                   coll["total_bytes"] * n_chips, n_chips),
        "roofline_io": roofline_terms(flops * n_chips, io * n_chips,
                                      coll["total_bytes"] * n_chips,
                                      n_chips),
        "build_s": build_s,
    }
    return out, rec


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

def _axis_of(mesh) -> Dict[str, str]:
    """Process-group name -> the mesh axis (or axes) it spans."""
    dm = mesh.device_mesh
    out = {dm.get_group(ax).group_name: ax for ax in dm.mesh_dim_names}
    out[mesh.data_group.group_name] = "+".join(
        a for a in ("pod", "data") if a in mesh.shape)
    out[dist.group.WORLD.group_name] = "world"
    return out


def _axis_dims(spec, axis: str) -> Optional[int]:
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


def rank_block(tree, spec_tree, mesh, axes=("pod", "data", "model")):
    """Rank 0's block of each meta leaf of ``tree``: cut along every dim
    its spec shards over one of ``axes`` (an empty meta tensor)."""
    def one(x, spec):
        shape = list(x.shape)
        for i, e in enumerate(spec):
            for ax in (e if isinstance(e, tuple) else (e,)):
                if ax in axes:
                    shape[i] //= mesh.shape.get(ax, 1)
        return torch.empty(shape, dtype=x.dtype, device="meta")
    specs = [s for _, s in sh.flat_specs(spec_tree)]
    leaves = tree_leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_unflatten(tree, [one(x, s) for x, s in zip(leaves, specs)])


def on_model_mesh(tree, spec_tree, mesh):
    """Each leaf of ``tree`` (rank 0's model shard) as a DTensor over the
    replica's model mesh, placed by its spec (``sharding.placements``)."""
    from torch.distributed.tensor import DTensor
    specs = [s for _, s in sh.flat_specs(spec_tree)]
    return tree_unflatten(tree, [
        DTensor.from_local(x, mesh.model_mesh, sh.placements(s),
                           run_check=False)
        for x, s in zip(tree_leaves(tree), specs)])


def gather_data(leaves, dims, mesh):
    """FSDP's all-gather: the model shards from rank 0's (data, model)
    shards, over its data group (``backends/tp.py::gather_model``)."""
    from repro_torch.backends.tp import gather_model
    return gather_model(leaves, dims, mesh.shape["data"], mesh.data_group)


def reduce_scatter_data(grads, dims, mesh):
    """FSDP's reduce-scatter: each gradient summed over the data group and
    cut to rank 0's block along its data dim (one reduce-scatter per
    dtype, rank-major), a gradient with no data dim summed whole (one
    all-reduce); then divided by the data size (the replica's batch is
    spread over it)."""
    n, group = mesh.shape["data"], mesh.data_group
    out = list(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    whole = []
    for i, (g, d) in enumerate(zip(grads, dims)):
        if d is None:
            whole.append(i)
        else:
            by_dtype.setdefault(g.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        chunks = [grads[i].chunk(n, dim=dims[i]) for i in idx]
        flat = torch.cat([c[r].reshape(-1) for r in range(n) for c in chunks])
        got = torch.empty(flat.numel() // n, dtype=dtype, device=flat.device)
        dist.reduce_scatter_tensor(got, flat, group=group)
        for i, c, part in zip(idx, chunks, got.split(
                [c[0].numel() for c in chunks])):
            out[i] = part.view(c[0].shape) / n
    if whole:
        flat = torch.cat([grads[i].reshape(-1).to(torch.float32)
                          for i in whole])
        dist.all_reduce(flat, group=group)
        for i, part in zip(whole, flat.split([grads[i].numel()
                                              for i in whole])):
            out[i] = (part / n).view(grads[i].shape).to(grads[i].dtype)
    return out


def _model_specs(spec_tree):
    """The specs with only their ``model`` entries (the layout the
    replica's DTensor step reads)."""
    def strip(e):
        if isinstance(e, tuple):
            e = tuple(a for a in e if a == "model")
            return e[0] if e else None
        return e if e == "model" else None
    return _map_specs(spec_tree, lambda s: tuple(strip(e) for e in s))


def _map_specs(spec_tree, fn):
    if sh._is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(v, fn) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(v, fn) for v in spec_tree)
    return spec_tree
def _data_dims(spec_tree, stacked: bool) -> List[Optional[int]]:
    """Each leaf's dim sharded over ``data`` (of a replica's own dims when
    ``stacked``), or None."""
    out = []
    for _, spec in sh.flat_specs(spec_tree):
        d = _axis_dims(spec, "data")
        out.append(None if d is None else d - int(stacked))
    return out


def _mesh_programs(run, mesh, shape, R, rep_axes, fns):
    """A replica_dp / replica_ddp plan on the mesh backend: rank 0's
    replicas (each over the model group under ``replica_tp``)."""
    from repro_torch.backends.mesh import MeshBackend
    from repro_torch.backends.ops import all_mean_op
    cfg, plan = run.model, run.parallelism.plan
    backend = MeshBackend(mesh, model_cfg=cfg, use_kernel=True,
                          placement=("replica_ddp" if plan == "replica_ddp"
                                     else "replica_tp"))
    backend.bind(R)
    W = backend.put_params(sp.abstract_params(cfg, n_replicas=backend.n_local))
    opt_state = backend.init_opt_state(fns["optimizer"], W)
    batch, _ = sp.train_batch_specs(cfg, shape, R, plan, replica_axes=rep_axes)
    batch = backend.local_replicas(batch)
    loss_fn, opt = fns["loss_fn"], fns["optimizer"]
    sync = backend.lower(all_mean_op(),
                         sync_momentum=run.averaging.sync_momentum)
    return {"local_step": (backend.replica_step(loss_fn, opt),
                           (W, opt_state, batch, LR)),
            "full_step": (backend.full_step(loss_fn, opt),
                          (W, opt_state, batch, LR)),
            "sync_step": (sync, (W, opt_state))}, backend.whole


def _fsdp_programs(run, mesh, shape, R, rep_axes, fns):
    """An fsdp plan: one replica per pod; rank 0 stores its (data, model)
    block of its pod's replica, as the fsdp specs shard it, and rows
    1/data of the pod's batch.  A step all-gathers the parameters over
    ``data`` into the model shards, runs the replica's forward and
    backward on DTensors over the model mesh (``backends/tp.py``, as
    ``replica_tp`` does), reduce-scatters the gradients over ``data`` and
    updates its block; FULLSGD also all-reduces them over ``pod``.  The
    sync is the mesh backend's, over ``pod``, on the blocks
    (``_pod_backend``).  Like the reference's, this program exists only
    in the dry run."""
    from repro_torch.backends import tp as tp_mod
    from repro_torch.backends.ops import all_mean_op
    from repro_torch.core import averaging as avg
    cfg, plan = run.model, run.parallelism
    pods = mesh.shape.get("pod", 1)
    pod_group = mesh.device_mesh.get_group("pod") if pods > 1 else None
    W0 = sp.abstract_params(cfg, n_replicas=R)
    pspec = sh.param_specs(cfg, W0, mesh.shape, plan, replica_axes=rep_axes,
                           stacked=True)
    opt_state = fns["optimizer"].init(rank_block(W0, pspec, mesh),
                                      n_replicas=1)
    W = rank_block(W0, pspec, mesh)
    batch0, bspec = sp.train_batch_specs(cfg, shape, R, "fsdp",
                                         replica_axes=rep_axes)
    batch = rank_block(batch0, bspec, mesh)
    layout = tp_mod.Layout(mesh.model_size, 0)
    layout.record(_model_specs(pspec))
    whole: Counter = Counter()
    shards = tp_mod.ModelShards(layout, mesh.model_mesh, mesh.model_group,
                                whole)
    ddims = _data_dims(pspec, stacked=True)
    loss_fn, opt = fns["loss_fn"], fns["optimizer"]

    def step(full: bool):
        def program(W, opt_state, batch, lr):
            shards.bind(W)
            Wr, opt_r = avg.replica_view(W, 0), avg.replica_view(opt_state, 0)
            params = tree_unflatten(Wr, gather_data(tree_leaves(Wr), ddims,
                                                    mesh))
            loss, aux, grads = avg.value_and_grad(
                loss_fn, params, avg.replica_view(batch, 0), shards)
            g = reduce_scatter_data(tree_leaves(grads), ddims, mesh)
            if full and pod_group is not None:
                flat = torch.cat([x.reshape(-1).to(torch.float32) for x in g])
                dist.all_reduce(flat, group=pod_group)
                g = [(p / pods).view(x.shape).to(x.dtype) for p, x in
                     zip(flat.split([x.numel() for x in g]), g)]
            with torch.no_grad():
                opt.update(tree_unflatten(Wr, g), opt_r, Wr, lr)
            return W, opt_state, {"loss": loss, **aux}
        return program

    sync = _pod_backend(mesh, cfg, R).lower(
        all_mean_op(), sync_momentum=run.averaging.sync_momentum)

    return {"local_step": (step(False), (W, opt_state, batch, LR)),
            "full_step": (step(True), (W, opt_state, batch, LR)),
            "sync_step": (sync, (W, opt_state))}, whole


def _pod_backend(mesh, cfg, R):
    """The mesh backend an fsdp plan syncs with: its replicas are the
    pods, and the pod's ranks (data x model) are one replica's model
    ranks, each holding its block of every leaf.  The sync is then the
    backend's own (``MeshBackend._lower_all_mean``) on the blocks: the
    kernel's mean summed over ``pod``, written back, S_k over the
    world."""
    from repro_torch.backends.mesh import MeshBackend
    from repro_torch.launch.mesh import ReplicaMesh
    pods = mesh.shape.get("pod", 1)
    group = (mesh.device_mesh.get_group("pod") if pods > 1
             else dist.new_group([mesh.rank]))
    pod_mesh = ReplicaMesh({"pod": pods, "model": mesh.world // pods},
                           mesh.rank, mesh.world, mesh.group, mesh.device,
                           data_group=group)
    backend = MeshBackend(pod_mesh, model_cfg=cfg, use_kernel=True)
    backend.bind(R)
    return backend


def _serve_program(run, mesh, shape):
    """Prefill or one decode step as the mesh backend runs a replica:
    rank 0's rows of the batch (over ``data`` where it divides) and of
    the caches (``cache_specs``), the parameters' model shards as
    DTensors over the model mesh (an fsdp plan all-gathers them over
    ``data`` first, from the blocks it stores)."""
    from repro_torch.backends import tp as tp_mod
    cfg, plan = run.model, run.parallelism
    tp_mod.install_fallbacks()
    params0 = sp.abstract_params(cfg)
    pspec = sh.param_specs(cfg, params0, mesh.shape, plan)
    ddims = _data_dims(pspec, stacked=False)
    mspec = _model_specs(pspec)
    whole: Counter = Counter()
    if shape.kind == "prefill":
        name, fn = "prefill_step", st.make_prefill_step(cfg)
        batch0, bspec = sp.prefill_batch_specs(cfg, shape, mesh.shape)
        extra = ()
    else:
        name, fn = "serve_step", st.make_serve_step(cfg)
        batch0, bspec = sp.decode_batch_specs(cfg, shape, mesh.shape)
        caches0 = sp.abstract_caches(cfg, shape.global_batch, shape.seq_len)
        cspec = sh.cache_specs(cfg, caches0, mesh.shape,
                               batch=shape.global_batch)
        extra = (rank_block(caches0, cspec, mesh),)

    @torch.no_grad()
    def program(params, batch, *caches):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        if any(d is not None for d in ddims):
            params = tree_unflatten(params, gather_data(
                tree_leaves(params), ddims, mesh))
        params = on_model_mesh(params, mspec, mesh)
        caches = [on_model_mesh(c, _model_specs(cspec), mesh)
                  for c in caches]
        with implicit_replication(), tp_mod.WholeWhereRefused(whole):
            return fn(params, batch, *caches)

    args = (rank_block(params0, pspec, mesh), rank_block(batch0, bspec, mesh),
            *extra)
    return name, program, args, whole


def analyze_program(run, shape, prog: str, multi_pod: bool = False
                    ) -> Dict[str, Any]:
    """Build ``prog`` of ``run`` at ``shape`` on a fresh dry-run mesh, run
    it under ``analyze`` and close the mesh."""
    mesh = make_dryrun_mesh(MULTI_POD_MESH if multi_pod else MESH)
    try:
        plan = run.parallelism.plan
        rep_axes = replica_axes_for(plan, multi_pod)
        R = n_replicas_for(mesh, plan, multi_pod)
        if shape.kind == "train":
            fns = st.make_steps(run)
            build = _fsdp_programs if plan == "fsdp" else _mesh_programs
            programs, whole = build(run, mesh, shape, R, rep_axes, fns)
            fn, args = programs[prog]
        else:
            name, fn, args, whole = _serve_program(run, mesh, shape)
            if prog != name:
                raise ValueError(f"a {shape.kind} shape runs {name}, "
                                 f"not {prog}")
        _, rec = analyze(fn, args, n_chips=mesh.world,
                         axis_of=_axis_of(mesh))
        rec["whole"] = dict(whole)
        return rec
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# Depth extrapolation (the reference's scan-cost correction)
# ---------------------------------------------------------------------------


def _weights(xs, x) -> List[float]:
    """Lagrange weights: the value at x of the polynomial of degree
    len(xs) - 1 through the points at xs is sum(w_i * v_i)."""
    out = []
    for i, xi in enumerate(xs):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        out.append(w)
    return out


def _fit(values, w, integer: bool = False):
    """The weighted sum of numbers, or of dicts of them key by key."""
    if isinstance(values[0], dict):
        keys = set().union(*values)
        return {k: _fit([v.get(k, 0) for v in values], w, integer)
                for k in keys}
    v = sum(wi * vi for wi, vi in zip(w, values))
    return int(round(v)) if integer else v


def _extrapolate_terms(recs: List[Dict], xs, x) -> Dict:
    """The reference's extrapolated terms at ``x`` from records built at
    ``xs``: flops, bytes, collective bytes and bytes by type (the counts
    by type are the last record's, as the reference keeps them)."""
    w = _weights(xs, x)
    out = {k: _fit([r[k] for r in recs], w) for k in
           ("flops_per_chip", "hbm_bytes_per_chip",
            "collective_bytes_per_chip")}
    out["collectives"] = {
        "bytes_by_type": _fit([r["collectives"]["bytes_by_type"]
                               for r in recs], w),
        "count_by_type": recs[-1]["collectives"]["count_by_type"],
        "total_bytes": out["collective_bytes_per_chip"]}
    return out


def _affine_extrapolate(a1: Dict, a2: Dict, L1: int, L2: int, L: int) -> Dict:
    """cost(L) from two builds at depths L1 < L2: cost is affine in the
    layer count (the reference's scan correction)."""
    return _extrapolate_terms([a1, a2], (L1, L2), L)


def _extrapolate_record(recs: List[Dict], xs, x, n_chips: int) -> Dict:
    """A whole record at depth ``x`` from records built at depths ``xs``
    (cost is affine in the layer count): every count through the line
    through the points, the call counts rounded; the rooflines
    recomputed."""
    w = _weights(xs, x)
    out = _extrapolate_terms(recs, xs, x)
    out["aten_flops_per_chip"] = _fit([r["aten_flops_per_chip"]
                                       for r in recs], w)
    coll = [r["collectives"] for r in recs]
    out["collectives"].update(
        count_by_type=_fit([c["count_by_type"] for c in coll], w, True),
        bytes_by_axis=_fit([c["bytes_by_axis"] for c in coll], w),
        count_by_axis=_fit([c["count_by_axis"] for c in coll], w, True))
    out["kernels"] = {
        k: {"calls": _fit([r["kernels"].get(k, {}).get("calls", 0)
                           for r in recs], w, True),
            "bytes": _fit([r["kernels"].get(k, {}).get("bytes", 0.0)
                           for r in recs], w),
            "ops": _fit([r["kernels"].get(k, {}).get("ops", 0.0)
                         for r in recs], w)}
        for k in set().union(*(r["kernels"] for r in recs))}
    out["memory"] = _fit([r["memory"] for r in recs], w, True)
    out["whole"] = _fit([r["whole"] for r in recs], w, True)
    out["top_ops"] = recs[-1]["top_ops"]
    out["io_bytes_per_chip"] = _fit([r["io_bytes_per_chip"] for r in recs],
                                    w)
    for key_, b in (("roofline", "hbm_bytes_per_chip"),
                    ("roofline_io", "io_bytes_per_chip")):
        out[key_] = roofline_terms(
            out["flops_per_chip"] * n_chips, out[b] * n_chips,
            out["collective_bytes_per_chip"] * n_chips, n_chips)
    out["build_s"] = sum(r["build_s"] for r in recs)
    out["cost_corrected"] = True
    out["depths"] = list(xs)
    return out


def _n_chips(multi_pod: bool) -> int:
    n = 1
    for v in (MULTI_POD_MESH if multi_pod else MESH).values():
        n *= v
    return n


def _corrected_analysis(run, shape, prog: str, multi_pod: bool
                        ) -> Optional[Dict[str, Any]]:
    """The record of ``prog`` at full depth from two cut depths of whole
    groups of the config's ``scan_grouping`` (prefix + n·P and prefix +
    (n + 1)·P layers), or None where it has none.  The reference's anchors
    are n = 1; under ``remat`` a group of P > 1 layers is one checkpoint
    only where the cut keeps two groups or more (as the reference scans
    them), so there n = 2, and each cut build checkpoints as the whole
    model does."""
    cfg = run.model
    g = cfg.scan_grouping()
    if g is None:
        return None
    prefix, P, _ = g
    n = 2 if cfg.remat and P > 1 else 1
    L1, L2 = prefix + n * P, prefix + (n + 1) * P
    if L2 >= cfg.n_layers:
        return None
    small = [analyze_program(dataclasses.replace(run, model=dataclasses.replace(
        cfg, n_layers=L)), shape, prog, multi_pod)
        for L in (L1, L2)]
    return _extrapolate_record(small, (L1, L2), cfg.n_layers,
                               _n_chips(multi_pod))


# ---------------------------------------------------------------------------
# Pairs
# ---------------------------------------------------------------------------

def default_programs(kind: str) -> List[str]:
    return {"train": ["local_step", "full_step", "sync_step"],
            "prefill": ["prefill_step"], "decode": ["serve_step"]}[kind]


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             programs: Optional[list] = None,
             run_override=None, correct: bool = True) -> Dict[str, Any]:
    """The record of one pair: each program's per-GPU counts, memory and
    roofline terms.  ``correct`` extrapolates train and prefill programs
    from two cut depths where the config has a ``scan_grouping``; a sync
    and a decode step are always built at full depth."""
    run = run_override or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_shape = MULTI_POD_MESH if multi_pod else MESH
    plan = run.parallelism.plan
    R = 1
    for ax in replica_axes_for(plan, multi_pod):
        R *= mesh_shape[ax]
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh_shape.values())),
        "plan": plan, "n_replicas": R, "programs": {},
        "torch": torch.__version__,
    }
    for prog in programs or default_programs(shape.kind):
        corr = None
        if correct and prog in ("local_step", "full_step", "prefill_step"):
            corr = _corrected_analysis(run, shape, prog, multi_pod)
        record["programs"][prog] = corr or analyze_program(
            run, shape, prog, multi_pod)
    return record


def pair_is_runnable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return False
    return True


def save_record(rec: Dict[str, Any]) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR,
                        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--programs", default=None,
                    help="comma list, e.g. local_step,sync_step")
    ap.add_argument("--no-correction", action="store_true",
                    help="build every program at full depth (slower; the "
                         "counts then need no extrapolation)")
    args = ap.parse_args()
    if args.all:
        pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES
                 if pair_is_runnable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("pass --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    progs = args.programs.split(",") if args.programs else None
    t_all = time.perf_counter()
    for a, s in pairs:
        t0 = time.perf_counter()
        try:
            rec = run_pair(a, s, multi_pod=args.multi_pod, programs=progs,
                           correct=not args.no_correction)
            path = save_record(rec)
            for pn, pr in rec["programs"].items():
                r = pr["roofline"]
                print(f"OK  {a:24s} {s:12s} {pn:12s} "
                      f"compute={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                      f"coll={r['collective_s']:.3e}s dom={r['dominant']:10s} "
                      f"peak={pr['memory']['peak_bytes'] / 2**30:.2f}GiB "
                      f"[{time.perf_counter() - t0:.0f}s] -> "
                      f"{os.path.basename(path)}", flush=True)
        except Exception as e:  # noqa: BLE001 — a failure IS the finding
            print(f"FAIL {a} {s}: {type(e).__name__}: {e}", flush=True)
            raise
    print(f"{len(pairs)} pairs in {time.perf_counter() - t_all:.1f} s "
          f"(torch {torch.__version__})")


if __name__ == "__main__":
    main()
