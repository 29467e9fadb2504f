"""Analytic communication model (port of the strategy-facing part of
``repro/core/comm_model.py``): the paper's ring all-reduce accounting
(16 nodes, 100 vs 10 Gbps).  A ring all-reduce of D bytes moves
2·(n−1)/n·D per node."""
from __future__ import annotations

from dataclasses import dataclass

GBPS_100 = 100e9 / 8     # bytes/s
GBPS_10 = 10e9 / 8
LATENCY_S = 5e-6         # per collective, per hop


@dataclass(frozen=True)
class CommStats:
    bytes_per_node: float
    n_events: int
    time_s: float


def ring_allreduce_bytes(n_params: int, n_nodes: int, bytes_per_el: int = 4) -> float:
    return 2.0 * (n_nodes - 1) / n_nodes * n_params * bytes_per_el


# Latency hops per collective kind, keyed by ``CollectiveOp.collective``
# (backends/ops.py): a ring all-reduce is 2(n-1) sequential hops, a ring
# all-gather n-1; a QSGD gather + broadcast keeps 2(n-1); a hierarchical
# inner mean prices its own group size.
COLLECTIVE_HOPS = {
    "all_reduce": lambda n: 2 * (n - 1),
    "all_gather": lambda n: n - 1,
    "gather_bcast": lambda n: 2 * (n - 1),
    "inner_mean": lambda n: 2 * (n - 1),
}


def comm_time(bytes_per_event: float, n_events: int, n_nodes: int,
              bandwidth: float, *, collective: str = "all_reduce",
              latency_s: float = LATENCY_S) -> float:
    """Wall-clock of ``n_events`` collectives of ``bytes_per_event`` each."""
    if collective not in COLLECTIVE_HOPS:
        raise ValueError(f"unknown collective '{collective}'; "
                         f"available: {sorted(COLLECTIVE_HOPS)}")
    lat = latency_s * COLLECTIVE_HOPS[collective](n_nodes)
    return n_events * (bytes_per_event / bandwidth + lat)
