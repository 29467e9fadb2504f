"""CollectiveOp IR — the declarative communication layer (port of
``repro/backends/ops.py``; the QSGD, hierarchical and DaSGD ops and the
``InFlightOp`` handle come with the strategies that emit them).

A ``CollectiveOp`` names one backend program: the collective kind, the wire
format of its payload, the participating group and whether it may overlap
compute.  Strategies emit descriptors, backends lower them
(``ExecutionBackend.lower``), and pricing reads the same descriptor
(``op.wire_bytes``), so the bytes an accounting path reports are the bytes
of the program that ran.
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


def all_mean_op() -> CollectiveOp:
    """The replica parameter mean + variance probe S_k (Algorithm 2
    lines 10-11) — one full-precision ring all-reduce."""
    return CollectiveOp("all_mean", "all_reduce")


def opt_mean_op() -> CollectiveOp:
    """Optimizer-state mean across replicas (sync_momentum knob)."""
    return CollectiveOp("opt_mean", "all_reduce")
