"""The pluggable execution-backend API (port of ``repro/backends/base.py``).

A ``CommunicationStrategy`` decides *when* and *what* replicas exchange; an
``ExecutionBackend`` decides where the replicas live and how each exchange
runs.  Strategies emit ``CollectiveOp`` descriptors (``backends/ops.py``)
and ask the backend to lower them:

    program = backend.lower(op, loss_fn=..., optimizer=...)

``op.name`` resolves to the backend's ``_lower_<name>`` method.  The
telemetry clocks of the reference (``runtime/clock.py``) are not ported
yet, so ``timed`` hands programs back unwrapped and ``set_clock`` accepts
only None.

Every backend has a device, resolved at construction: the card unless the
caller passes ``device="cpu"`` (without CUDA, the default raises).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Type

from repro_torch.backends import ops as collective_ops
from repro_torch.backends.ops import CollectiveOp
from repro_torch.core import averaging as avg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

Pytree = Any


class ExecutionBackend:
    """Base class; concrete backends override placement + ``_lower_*``
    program lowerings.

    ``use_kernel`` selects the fused mean + sqdev kernel inside
    ``all_mean``: ``True``/``False`` force it; ``None`` (default) turns it
    on whenever the parameters are on CUDA.  ``False`` keeps the
    reference's plain sync and is never the default.
    """

    name = "base"

    def __init__(self, *, use_kernel: Optional[bool] = None,
                 device: DeviceLike = None):
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.n_replicas: Optional[int] = None

    def bind(self, n_replicas: int) -> None:
        self.n_replicas = int(n_replicas)

    def describe(self) -> Dict[str, Any]:
        return {"backend": self.name, "n_replicas": self.n_replicas,
                "n_devices": 1, "device": str(self.device)}

    # ------------------------------------------------------------ telemetry
    def set_clock(self, clock) -> None:
        if clock is not None:
            raise NotImplementedError(
                "telemetry clocks (runtime/clock.py) are not ported yet")

    def timed(self, op: CollectiveOp, fn: Callable) -> Callable:
        """The hook where a bound clock will price each invocation from
        ``op``; with no clock the program runs as built."""
        return fn

    # ------------------------------------------------------------- lowering
    def lower(self, op: CollectiveOp, **kw) -> Callable:
        build = getattr(self, f"_lower_{op.name}", None)
        if build is None:
            raise KeyError(
                f"backend '{self.name}' cannot lower op '{op.name}'")
        return self.timed(op, build(op, **kw))

    def all_mean(self, *, sync_momentum: bool = False) -> Callable:
        """(W, opt_state) -> (W, opt_state, s_k): the replica average and
        the paper's variance probe."""
        return self.lower(collective_ops.all_mean_op(),
                          sync_momentum=sync_momentum)

    # ------------------------------------------------------------ placement
    def put_params(self, W: Pytree) -> Pytree:
        return tree_map(lambda x: x.to(self.device), W)

    def put_opt(self, opt_state: Pytree, W: Pytree) -> Pytree:
        return tree_map(lambda x: x.to(self.device), opt_state)

    def init_opt_state(self, optimizer, W: Pytree) -> Pytree:
        return self.put_opt(
            optimizer.init(W, n_replicas=avg.n_replicas(W)), W)


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
