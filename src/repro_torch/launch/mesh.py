"""The replica mesh on ``torch.distributed`` (port of
``repro/launch/mesh.py``).

One process per GPU.  A ``ReplicaMesh`` names the axes the reference's
``jax.sharding.Mesh`` has (``pod`` / ``data`` / ``model``), this process's
rank in the world, the process group and the rank's device.  The group is
NCCL for a mesh on the card and gloo for one on the CPU.

``make_host_mesh`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and ``MASTER_ADDR`` /
``MASTER_PORT`` for the rendezvous).  Without it, it builds a one-rank
group on a ``TCPStore`` on 127.0.0.1.  Given an initialised group (tests
and ``chip_smoke.py`` create and destroy their own), it takes that one.

Only ``model_parallel=1`` runs here: every rank holds whole-model replicas
(the ``replica_ddp`` placement).  A ``model`` axis above 1 is the
``replica_tp`` placement, whose tensor-parallel collectives are the next
slice of the port.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import REPLICA_TP_SLICE
from repro_torch.device import DeviceLike

# a rank that waits longer than this on a collective fails instead of
# hanging its job
TIMEOUT = timedelta(seconds=600)


@dataclass
class ReplicaMesh:
    """Axis sizes (``shape``, in the reference's axis order), this
    process's ``rank`` and ``world`` size, its process ``group`` and its
    ``device``.  ``owns_group`` is True when ``make_host_mesh`` created
    the group; ``close()`` then destroys it."""

    shape: Dict[str, int]
    rank: int
    world: int
    group: object
    device: torch.device
    owns_group: bool = False
    backend: str = field(init=False)

    def __post_init__(self):
        self.backend = dist.get_backend(self.group)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    """The CPU when asked; else ``cuda:LOCAL_RANK``, which must exist."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a gloo mesh on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local_rank} has no GPU: this host "
                           f"shows {torch.cuda.device_count()}")
    return torch.device("cuda", local_rank)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(device: torch.device, *, rank: int = 0, world: int = 1,
               store=None, timeout: timedelta = TIMEOUT) -> None:
    """The default process group: NCCL for a device on the card (bound to
    that device), gloo for the CPU.  ``store`` None means torchrun's
    environment (``env://``), or a one-rank ``TCPStore`` on 127.0.0.1
    when there is none."""
    if store is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise RuntimeError("a mesh of several ranks needs a launcher "
                               "(python -m torch.distributed.run) or a store")
        store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                              timeout=timeout)
    kw = dict(backend="nccl" if device.type == "cuda" else "gloo",
              rank=rank, world_size=world, timeout=timeout)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)


def make_host_mesh(model_parallel: int = 1, *, device: DeviceLike = None,
                   group=None) -> ReplicaMesh:
    """The mesh of this job's ranks: ``data`` = the world size, ``model``
    = 1.  Joins the initialised default group (or ``group``), else
    creates the default group from torchrun's environment, or a one-rank
    group without one."""
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: "
                                  + REPLICA_TP_SLICE)
    dev = _rank_device(device, _env_int("LOCAL_RANK", 0))
    owns = False
    if group is None:
        if not dist.is_initialized():
            init_group(dev, rank=_env_int("RANK", 0),
                       world=_env_int("WORLD_SIZE", 1))
            owns = True
        group = dist.group.WORLD
    world = dist.get_world_size(group)
    if dev.type == "cuda" and dist.get_backend(group) != "nccl":
        raise RuntimeError(f"a mesh on {dev} needs an NCCL group, got "
                           f"{dist.get_backend(group)}")
    if dev.type == "cpu" and dist.get_backend(group) != "gloo":
        raise RuntimeError(f"a mesh on the CPU needs a gloo group, got "
                           f"{dist.get_backend(group)}")
    return ReplicaMesh({"data": world, "model": 1},
                       dist.get_rank(group), world, group, dev,
                       owns_group=owns)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> ReplicaMesh:
    """The production layout on H100 hosts, in the reference's axis names.
    It replaces the reference's TPU v5e layout (one pod of 16 x 16 chips
    as data x model; two pods as pod x data x model): here ``pod`` is a
    node, one NVLink domain (``WORLD_SIZE / LOCAL_WORLD_SIZE`` of them),
    ``data`` the GPUs of a node (``LOCAL_WORLD_SIZE``) and ``model`` 1.
    Single-pod (``multi_pod=False``), ``data`` spans the whole world."""
    mesh = make_host_mesh(1, device=device)
    if multi_pod:
        per_node = _env_int("LOCAL_WORLD_SIZE", mesh.world)
        if mesh.world % per_node:
            raise ValueError(f"WORLD_SIZE {mesh.world} is not a whole number "
                             f"of nodes of {per_node} GPUs")
        mesh.shape = {"pod": mesh.world // per_node, "data": per_node,
                      "model": 1}
    return mesh


def replica_axes_for(plan: str, multi_pod: bool):
    """Mesh axes consumed by the leading replica dim (DESIGN.md §4)."""
    if plan in ("replica_dp", "replica_ddp"):
        return ("pod", "data") if multi_pod else ("data",)
    # fsdp: local-SGD replicas only across pods (DiLoCo-style)
    return ("pod",) if multi_pod else ()


def n_replicas_for(mesh: ReplicaMesh, plan: str, multi_pod: bool) -> int:
    r = 1
    for ax in replica_axes_for(plan, multi_pod):
        r *= mesh.shape.get(ax, 1)
    return max(r, 1)


def replica_range(mesh: ReplicaMesh, n_replicas: int) -> range:
    """The global indices of this rank's contiguous chunk of replicas."""
    per = n_replicas // mesh.world
    return range(mesh.rank * per, (mesh.rank + 1) * per)
