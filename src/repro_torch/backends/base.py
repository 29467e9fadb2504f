"""The pluggable execution-backend API (port of ``repro/backends/base.py``).

A ``CommunicationStrategy`` decides *when* and *what* replicas exchange; an
``ExecutionBackend`` decides where the replicas live and how each exchange
runs.  Strategies emit ``CollectiveOp`` descriptors (``backends/ops.py``)
and ask the backend to lower them:

    program = backend.lower(op, loss_fn=..., optimizer=...)

``op.name`` resolves to the backend's ``_lower_<name>`` method, and the
program comes back wrapped by ``timed``: with a telemetry clock bound
(``set_clock``, ``runtime/clock.py``) each invocation is priced from the
descriptor itself (``op.wire_bytes``) into the clock's Timeline.  Ops with
``overlap=True`` return an ``InFlightOp`` fetched later (DaSGD).

Every backend has a device, resolved at construction: the card unless the
caller passes ``device="cpu"`` (without CUDA, the default raises).

A backend whose replicas live in several processes (``world`` > 1, the
mesh backend) holds ``n_local`` = R / world of them in each, a contiguous
chunk from replica ``rank · n_local``.  The hooks ``stack_params``,
``local_replicas``, ``gather_replicas``, ``get`` and ``is_writer`` keep
the engine and the checkpoints free of that: a one-process backend holds
every replica, and each hook is the identity there.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Type

import numpy as np
import torch

from repro_torch.backends import ops as collective_ops
from repro_torch.backends.ops import CollectiveOp, InFlightOp
from repro_torch.core import averaging as avg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


class ExecutionBackend:
    """Base class; concrete backends override placement + ``_lower_*``
    program lowerings.

    ``use_kernel`` selects the kernels inside the syncs and the QSGD step
    (the fused mean + sqdev kernel, and QSGD's sqnorm / quantize /
    dequantize): ``True``/``False`` force them; ``None`` (default) turns
    them on whenever the parameters are on CUDA.  ``False`` keeps the
    reference's plain arithmetic and is never the default.
    """

    name = "base"
    rank = 0                   # this process's place in the world
    world = 1                  # processes the replicas are spread over

    def __init__(self, *, use_kernel: Optional[bool] = None,
                 device: DeviceLike = None):
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.n_replicas: Optional[int] = None
        self.clock = None              # telemetry clock (runtime/clock.py)

    def bind(self, n_replicas: int) -> None:
        self.n_replicas = int(n_replicas)

    def kernel_policy(self) -> bool:
        """Whether the kernels run on this backend's device."""
        return (self.device.type == "cuda" if self.use_kernel is None
                else self.use_kernel)

    def kernel_on(self, W) -> bool:
        """Whether the kernels run on the parameters ``W``."""
        if self.use_kernel is not None:
            return self.use_kernel
        return tree_leaves(W)[0].is_cuda

    @property
    def n_local(self) -> int:
        """Replicas this process holds."""
        return (self.n_replicas or 1) // self.world

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and histories."""
        return self.rank == 0

    def describe(self) -> Dict[str, Any]:
        return {"backend": self.name, "n_replicas": self.n_replicas,
                "n_devices": 1, "device": str(self.device)}

    # ------------------------------------------------------------ telemetry
    def set_clock(self, clock) -> None:
        """Bind a ``runtime/clock.py`` Clock (None unbinds).  The ``timed``
        wrappers read ``self.clock`` at call time, so binding before or
        after lowering both work."""
        self.clock = clock

    def timed(self, op: CollectiveOp, fn: Callable) -> Callable:
        """Wrap a program so each invocation reports one ``(compute_s,
        comm_s, bytes)`` record into the bound clock's Timeline.  Bytes
        are ``op.wire_bytes`` of the per-replica parameter count, read off
        the stacked first operand (this process's replicas) per call; the
        collective kind and group ride the op; ``overlap=True`` ops return
        an ``InFlightOp``."""

        def wrapped(*args):
            clock = self.clock
            if clock is None:
                out = fn(*args)
                return InFlightOp(op, out) if op.overlap else out
            n = self.n_replicas or 1
            nbytes = 0.0
            if op.collective is not None:
                if op.group:
                    n = int(op.group)
                nbytes = op.wire_bytes(self.n_params(args[0]), n,
                                       n_tensors=len(tree_leaves(args[0])))
            if op.overlap:
                out, rec = clock.dispatch_async(
                    op.name, fn, args, comm_bytes=nbytes,
                    collective=op.collective, n_nodes=n)
                return InFlightOp(op, out, clock, rec)
            return clock.measure(op.name, fn, args, is_step=op.is_step,
                                 comm_bytes=nbytes, collective=op.collective,
                                 n_nodes=n)

        return wrapped

    # ------------------------------------------------------------- lowering
    def lower(self, op: CollectiveOp, **kw) -> Callable:
        build = getattr(self, f"_lower_{op.name}", None)
        if build is None:
            raise KeyError(
                f"backend '{self.name}' cannot lower op '{op.name}'")
        return self.timed(op, build(op, **kw))

    # ---------------------------------------------- named-op sugar
    # thin wrappers over lower(<canonical op>) for tests and benchmarks;
    # strategies emit the descriptors directly

    def replica_step(self, loss_fn, optimizer) -> Callable:
        """(W, opt_state, batch, lr) -> (W, opt_state, metrics); no
        collective in the step itself."""
        return self.lower(collective_ops.replica_step_op(),
                          loss_fn=loss_fn, optimizer=optimizer)

    def full_step(self, loss_fn, optimizer) -> Callable:
        """(W, opt_state, batch, lr) -> (W, opt_state, metrics); gradients
        all-reduced every call (FULLSGD)."""
        return self.lower(collective_ops.full_step_op(),
                          loss_fn=loss_fn, optimizer=optimizer)

    def opt_mean(self) -> Callable:
        """(opt_state) -> opt_state averaged across replicas."""
        return self.lower(collective_ops.opt_mean_op())

    def all_mean(self, *, sync_momentum: bool = False) -> Callable:
        """(W, opt_state) -> (W, opt_state, s_k): the replica average and
        the paper's variance probe."""
        return self.lower(collective_ops.all_mean_op(),
                          sync_momentum=sync_momentum)

    def qsgd_step(self, loss_fn, optimizer, bits: int) -> Callable:
        """(W, opt_state, batch, lr, key) -> (W, opt_state, metrics);
        quantized gradient exchange every call (QSGD)."""
        return self.lower(collective_ops.qsgd_step_op(bits),
                          loss_fn=loss_fn, optimizer=optimizer)

    def quantized_all_mean(self, bits: int) -> Callable:
        """(W, anchor, key) -> (W, new_anchor, s_k): byte-true QSGD deltas
        from the full-precision anchor — int8 levels + norms on the wire,
        dequantized at the receiver, averaged and re-applied."""
        return self.lower(collective_ops.quantized_all_mean_op(bits))

    def inner_mean(self, group_size: int) -> Callable:
        """(W) -> W averaged within contiguous replica groups of
        ``group_size`` (hierarchical in-pod sync), in place."""
        return self.lower(collective_ops.inner_mean_op(group_size))

    def mean_delta(self, *, overlap: bool = False) -> Callable:
        """(W) -> (delta, s_k) with ``delta_i = mean(W) − W_i`` (stacked,
        f32): the correction DaSGD applies ``delay`` steps later.  With
        ``overlap=True`` the call returns an ``InFlightOp``."""
        return self.lower(collective_ops.mean_delta_op(overlap=overlap))

    def apply_delta(self) -> Callable:
        """(W, delta) -> W + delta, in place (no collective: it happened
        in ``mean_delta``)."""
        return self.lower(collective_ops.apply_delta_op())

    # ------------------------------------------------------------ placement
    def stack_params(self, params0: Pytree) -> Pytree:
        """This process's replicas of a single-model tree: ``n_local``
        identical copies on its device."""
        return avg.stack_replicas(self.put_params(params0), self.n_local)

    def local_replicas(self, tree: Pytree) -> Pytree:
        """This process's rows of a tree stacked over all R replicas (a
        checkpoint, a batch); the tree itself where it holds them all."""
        return tree

    def gather_replicas(self, tree: Pytree) -> Pytree:
        """The tree stacked over all R replicas from each process's rows
        (the checkpoint's, placement-neutral layout); the tree itself where
        this process holds them all."""
        return tree

    def whole_shapes(self, tree: Pytree) -> List[tuple]:
        """The shape of each leaf as a whole replica-stacked leaf of this
        process's rows (a process holding shards of each replica, the
        mesh's ``replica_tp``, has 1/m of some dims)."""
        return [tuple(x.shape) for x in tree_leaves(tree)]

    def n_params(self, tree: Pytree) -> int:
        """Parameters of one replica in a stacked tree of this process."""
        return sum(math.prod(s) for s in self.whole_shapes(tree)) \
            // self.n_local

    def rank_bytes(self, tree: Pytree) -> List[int]:
        """The bytes of a tree each process holds, by rank."""
        return [sum(x.numel() * x.element_size() for x in tree_leaves(tree))]

    def get(self, tree: Pytree) -> Pytree:
        """A replica-stacked tree over all R replicas, on the host."""
        return tree_map(lambda x: x.detach().cpu(),
                        self.gather_replicas(tree))

    def parameter_variance(self, W: Pytree) -> torch.Tensor:
        """Var[W_k] over all R replicas (paper Eq. 7)."""
        return avg.parameter_variance(W)

    def barrier(self) -> None:
        """Wait for every process (after a checkpoint is written)."""

    def close(self) -> None:
        """Release what the backend set up (the mesh's process group)."""

    def put_params(self, W: Pytree) -> Pytree:
        return tree_map(lambda x: x.to(self.device), W)

    def put_opt(self, opt_state: Pytree, W: Pytree) -> Pytree:
        return tree_map(lambda x: x.to(self.device), opt_state)

    def put_replicated(self, tree: Pytree) -> Pytree:
        """Place an unstacked tree (the qsgd_periodic anchor) on this
        backend's device."""
        return tree_map(lambda x: x.to(self.device), tree)

    def own(self, tree: Pytree) -> Pytree:
        """Fresh contiguous tensors on this backend's device holding the
        leaves of ``tree`` (tensors or host arrays).  The programs write
        W, the optimizer state and the qsgd_periodic anchor in place, so
        restored state shares no buffer with what it was restored from."""

        def fresh(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            return torch.empty(tuple(x.shape), dtype=x.dtype,
                               device=self.device).copy_(x)

        return tree_map(fresh, tree)

    def init_opt_state(self, optimizer, W: Pytree) -> Pytree:
        return self.put_opt(
            optimizer.init(W, n_replicas=avg.n_replicas(W)), W)

    def collapse(self, W: Pytree) -> Pytree:
        """Replica mean without the probe (anchor seeding)."""
        return avg.replica_mean(W)

    def default_group_size(self) -> Optional[int]:
        """Topology-derived hierarchical group size, or None when the
        backend has no natural group boundary (one device): the
        hierarchical strategy then uses its config or half the replicas."""
        return None

    def _lower_apply_delta(self, op: CollectiveOp):
        """Elementwise add, shared by every backend, in place: the fetched
        delta (f32) is added into W's leaves, so the overlap window holds
        no third parameter-sized buffer."""

        @torch.no_grad()
        def apply(W, delta):
            for w, d in zip(tree_leaves(W), tree_leaves(delta)):
                if w.dtype == torch.float32:
                    w.add_(d)
                else:
                    w.copy_((w.to(torch.float32) + d).to(w.dtype))
            return W

        return apply


_BACKENDS: Dict[str, Type[ExecutionBackend]] = {}


def register_backend(cls: Type[ExecutionBackend]):
    """Class decorator: register under ``cls.name``."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"{cls.__name__} needs a unique .name")
    _BACKENDS[cls.name] = cls
    return cls


def get_backend_cls(name: str) -> Type[ExecutionBackend]:
    if name not in _BACKENDS:
        raise KeyError(
            f"unknown backend '{name}'; available: {available_backends()}")
    return _BACKENDS[name]


def make_backend(name: str, **kw) -> ExecutionBackend:
    return get_backend_cls(name)(**kw)


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def resolve_backend(backend, *, device: DeviceLike = None) -> ExecutionBackend:
    """None -> default VmapBackend on ``device``; str -> registry; instance
    -> itself."""
    if backend is None:
        backend = "vmap"
    if isinstance(backend, str):
        return make_backend(backend, device=device)
    if not isinstance(backend, ExecutionBackend):
        raise TypeError(f"expected backend name or ExecutionBackend, "
                        f"got {type(backend).__name__}")
    return backend
