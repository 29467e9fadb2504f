"""CollectiveOp IR — the declarative communication layer (port of
``repro/backends/ops.py``).

A ``CollectiveOp`` names one backend program: the collective kind, the wire
format of its payload, the participating group and whether it may overlap
compute.  Strategies emit descriptors, backends lower them
(``ExecutionBackend.lower``), and pricing reads the same descriptor
(``op.wire_bytes``), so the bytes an accounting path reports are the bytes
of the program that ran.  An ``overlap=True`` op returns an ``InFlightOp``
whose results the caller fetches later (DaSGD's delayed correction).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class WireFormat:
    """How one parameter component travels: ``f32`` (4 bytes) or
    ``qsgd_int8`` (``bits/8`` bytes plus a per-tensor f32 norm)."""

    kind: str = "f32"               # "f32" | "qsgd_int8"
    bits: int = 32
    norm_bytes_per_tensor: int = 0


def qsgd_wire(bits: int, *, norms: bool = True) -> WireFormat:
    """QSGD levels: ``bits``-bit components, plus 4-byte per-tensor norms
    when ``norms`` (the byte-true anchor-delta exchange counts them; the
    every-step gradient baseline keeps the paper's levels-only charge)."""
    return WireFormat("qsgd_int8", int(bits), 4 if norms else 0)


@dataclass(frozen=True)
class CollectiveOp:
    """One backend program, declaratively.  ``collective`` is a
    ``comm_model.COLLECTIVE_HOPS`` kind (None = no cross-replica exchange);
    ``is_step`` programs are per-step compute; ``group`` restricts the
    exchange to that many replicas; ``overlap`` ops may run off the step
    path."""

    name: str
    collective: Optional[str] = None
    is_step: bool = False
    wire: WireFormat = field(default_factory=WireFormat)
    group: Optional[int] = None
    overlap: bool = False

    def payload_bytes(self, n_params: int, n_tensors: int = 0) -> float:
        """Bytes one node puts on the wire per event."""
        return (n_params * self.wire.bits / 8.0
                + n_tensors * self.wire.norm_bytes_per_tensor)

    def wire_bytes(self, n_params: int, n_nodes: int,
                   n_tensors: int = 0) -> float:
        """Per-node bytes of one invocation over ``n_nodes``: a
        bandwidth-optimal ring moves ``2(n−1)/n`` of the payload."""
        if self.collective is None or n_nodes <= 1:
            return 0.0
        return (2.0 * (n_nodes - 1) / n_nodes
                * self.payload_bytes(n_params, n_tensors))


def replica_step_op() -> CollectiveOp:
    """Independent local SGD step per replica; no collectives."""
    return CollectiveOp("replica_step", None, is_step=True)


def full_step_op() -> CollectiveOp:
    """FULLSGD: gradients ring-all-reduced every step."""
    return CollectiveOp("full_step", "all_reduce", is_step=True)


def qsgd_step_op(bits: int) -> CollectiveOp:
    """QSGD baseline: quantized gradients every step.  Levels are not
    ring-reducible -> gather+broadcast (paper §IV); the paper's accounting
    charges bits/32 of the volume, norms excluded."""
    return CollectiveOp("qsgd_step", "gather_bcast", is_step=True,
                        wire=qsgd_wire(bits, norms=False))


def all_mean_op() -> CollectiveOp:
    """The replica parameter mean + variance probe S_k (Algorithm 2
    lines 10-11) — one full-precision ring all-reduce."""
    return CollectiveOp("all_mean", "all_reduce")


def opt_mean_op() -> CollectiveOp:
    """Optimizer-state mean across replicas (sync_momentum knob)."""
    return CollectiveOp("opt_mean", "all_reduce")


def quantized_all_mean_op(bits: int) -> CollectiveOp:
    """Byte-true QSGD anchor-delta exchange: int8 levels + per-tensor norms
    are gathered and dequantized at the receiver, so the wire carries
    ~bits/32 of the f32 volume plus the norm side-channel."""
    return CollectiveOp("quantized_all_mean", "gather_bcast",
                        wire=qsgd_wire(bits))


def inner_mean_op(group_size: int) -> CollectiveOp:
    """Hierarchical in-group partial average: a ring within one group of
    ``group_size`` replicas, priced on the group and the in-pod link."""
    return CollectiveOp("inner_mean", "inner_mean", group=int(group_size))


def mean_delta_op(*, overlap: bool = False) -> CollectiveOp:
    """DaSGD correction snapshot ``w̄ − w_i`` (the pair's only collective).
    ``overlap=True`` returns an ``InFlightOp``, fetched ``delay`` steps
    later."""
    return CollectiveOp("mean_delta", "all_reduce", overlap=overlap)


def apply_delta_op() -> CollectiveOp:
    """Collective-free elementwise add of a previously fetched delta."""
    return CollectiveOp("apply_delta", None)


class Deferred:
    """Outputs an overlap program has not finished: its collective is in
    flight (the mesh backend's snapshot).  ``finish()`` waits for it and
    returns the outputs (``finish``, the callable given, computes them)."""

    def __init__(self, finish):
        self.finish = finish


def settle(outputs):
    """The outputs of an overlap program: ``outputs.finish()`` for a
    ``Deferred``, the outputs themselves otherwise."""
    return outputs.finish() if isinstance(outputs, Deferred) else outputs


class InFlightOp:
    """A dispatched ``overlap=True`` collective whose results have not been
    fetched.  Its work is queued on the same CUDA stream as the steps, so
    it reads W before the next step writes it; its outputs may be a
    ``Deferred`` whose collective is still in flight.  ``fetch()`` returns
    the outputs and settles the exchange with the bound clock exactly
    once."""

    def __init__(self, op: CollectiveOp, outputs, clock=None, record=None):
        self.op = op
        self._outputs = outputs
        self._clock = clock
        self._record = record
        self.fetched = False

    def fetch(self):
        if not self.fetched:
            self.fetched = True
            if self._clock is not None:
                self._outputs = self._clock.complete_async(
                    self.op.name, self._record, self._outputs)
            else:
                self._outputs = settle(self._outputs)
        return self._outputs
