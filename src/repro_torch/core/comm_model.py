"""Analytic communication model (port of ``repro/core/comm_model.py``):
the paper's ring all-reduce accounting (16 nodes, 100 vs 10 Gbps; a ring
all-reduce of D bytes moves 2·(n−1)/n·D per node), and the roofline terms
of a program on H100 GPUs (``roofline_terms``, the reference's arithmetic
with the H100 SXM's rates in place of the TPU v5e's)."""
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


def method_comm(method: str, n_params: int, n_nodes: int, total_steps: int,
                n_syncs: int, bandwidth: float, qsgd_bits: int = 8) -> CommStats:
    """Total communication of a training run, per node, for the paper's
    methods (``strategies.comm_stats_for`` covers every strategy)."""
    coll = "all_reduce"
    if method in ("fullsgd",):
        per = ring_allreduce_bytes(n_params, n_nodes)
        ev = total_steps
    elif method in ("cpsgd", "adpsgd", "decreasing"):
        per = ring_allreduce_bytes(n_params, n_nodes)
        ev = n_syncs
    elif method == "qsgd":
        # 8-bit levels, norms neglected; gather + broadcast, latency kept
        per = ring_allreduce_bytes(n_params, n_nodes) * qsgd_bits / 32.0
        ev = total_steps
        coll = "gather_bcast"
    else:
        raise ValueError(method)
    return CommStats(per, ev, comm_time(per, ev, n_nodes, bandwidth,
                                        collective=coll))


def speedup_vs_fullsgd(method: str, n_params: int, n_nodes: int,
                       total_steps: int, n_syncs: int, step_compute_s: float,
                       bandwidth: float) -> float:
    """Modeled wall-clock speedup of ``method`` over FULLSGD (paper Fig
    4c)."""
    full = method_comm("fullsgd", n_params, n_nodes, total_steps,
                       total_steps, bandwidth)
    this = method_comm(method, n_params, n_nodes, total_steps, n_syncs,
                       bandwidth)
    t_full = total_steps * step_compute_s + full.time_s
    t_this = total_steps * step_compute_s + this.time_s
    return t_full / t_this


# --- H100 SXM roofline constants (NVIDIA data sheet, dense, 700 W) --------
PEAK_FLOPS_BF16 = 989e12         # per GPU, bf16 tensor cores
HBM_BW = 3.35e12                 # bytes/s of device memory per GPU
ICI_BW = 450e9                   # bytes/s per direction per GPU, NVLink 4


def roofline_terms(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
                   n_chips: int, ici_links: int = 1) -> dict:
    """The three least times of a program over ``n_chips`` GPUs (the
    reference's arithmetic): its FLOPs at the bf16 peak, its bytes at the
    HBM rate and its collective bytes at ``ICI_BW`` times ``ici_links``.
    ``ICI_BW`` prices NVLink 4, the link inside one 8-GPU node (the
    ``model`` axis); traffic between nodes (the ``data`` and ``pod``
    axes) crosses the NICs, which are slower, and the dry run's records
    keep collective bytes by mesh axis so it can be priced apart."""
    c = hlo_flops / (n_chips * PEAK_FLOPS_BF16)
    m = hlo_bytes / (n_chips * HBM_BW)
    x = collective_bytes / (n_chips * ICI_BW * ici_links)
    dom = max((c, "compute"), (m, "memory"), (x, "collective"))
    return {"compute_s": c, "memory_s": m, "collective_s": x,
            "dominant": dom[1], "bound_s": dom[0]}
