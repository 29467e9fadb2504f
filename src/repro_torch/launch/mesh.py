"""The replica mesh on ``torch.distributed`` (port of
``repro/launch/mesh.py``).

One process per GPU.  A ``ReplicaMesh`` names the axes the reference's
``jax.sharding.Mesh`` has (``pod`` / ``data`` / ``model``), this process's
rank in the world, the process groups and the rank's device.  The groups
are NCCL for a mesh on the card and gloo for one on the CPU.

``make_host_mesh(model_parallel=m)`` lays the world's ranks out as
``(data, model) = (world / m, m)`` in ``jax.make_mesh``'s order: rank r
is data index r // m and model index r % m.  The data group of a rank
joins the ranks of its model index (the replicas' syncs run there), its
model group the m ranks of its data index (one replica spread over them,
the ``replica_tp`` placement), and ``model_mesh`` is that group as a
one-dimensional ``DeviceMesh`` for DTensor.  With m = 1 every rank holds
whole replicas (``replica_ddp``) and the data group is the world; the
model group is a group of its own even of one rank, so that what runs
over it can be told from what runs over the world.

``make_host_mesh`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and ``MASTER_ADDR`` /
``MASTER_PORT`` for the rendezvous).  Without it, it builds a one-rank
group on a ``TCPStore`` on 127.0.0.1.  Given an initialised group (tests
and ``chip_smoke.py`` create and destroy their own), it takes that one.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

# a rank that waits longer than this on a collective fails instead of
# hanging its job
TIMEOUT = timedelta(seconds=600)


@dataclass
class ReplicaMesh:
    """Axis sizes (``shape``, in the reference's axis order), this
    process's ``rank`` and ``world`` size, its world ``group``, its
    ``data_group`` and ``model_group`` (the world itself and None for a
    mesh of whole replicas built by hand), the model group as a
    ``DeviceMesh`` (``model_mesh``) and its ``device``.  ``owns_group``
    is True when ``make_host_mesh`` created the world group; ``close()``
    then destroys it."""

    shape: Dict[str, int]
    rank: int
    world: int
    group: object
    device: torch.device
    owns_group: bool = False
    data_group: object = None
    model_group: object = None
    model_mesh: object = None
    backend: str = field(init=False)

    def __post_init__(self):
        self.backend = dist.get_backend(self.group)
        if self.data_group is None:
            self.data_group = self.group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

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


def make_host_mesh(model_parallel: int = 1, *,
                   device: DeviceLike = None) -> ReplicaMesh:
    """The mesh of this job's ranks: ``data`` = world / ``model_parallel``,
    ``model`` = ``model_parallel``.  Joins the initialised default group,
    else creates it from torchrun's environment, or a one-rank group
    without one.  A model axis that does not divide the world is refused
    before any group is touched."""
    m = int(model_parallel)
    world = (dist.get_world_size() if dist.is_initialized()
             else _env_int("WORLD_SIZE", 1))
    if m < 1 or world % m:
        raise ValueError(f"model_parallel={m} does not divide the world's "
                         f"{world} ranks")
    dev = _rank_device(device, _env_int("LOCAL_RANK", 0))
    owns = False
    if not dist.is_initialized():
        init_group(dev, rank=_env_int("RANK", 0), world=world)
        owns = True
    group = dist.group.WORLD
    if dev.type == "cuda" and dist.get_backend(group) != "nccl":
        raise RuntimeError(f"a mesh on {dev} needs an NCCL group, got "
                           f"{dist.get_backend(group)}")
    if dev.type == "cpu" and dist.get_backend(group) != "gloo":
        raise RuntimeError(f"a mesh on the CPU needs a gloo group, got "
                           f"{dist.get_backend(group)}")
    rank, n_data = dist.get_rank(group), world // m
    data_group, model_group = group, None
    # every rank creates every group, in one order (new_group is
    # collective over the world)
    for d in range(n_data):
        g = dist.new_group([d * m + i for i in range(m)], timeout=TIMEOUT)
        if d == rank // m:
            model_group = g
    if m > 1:
        for i in range(m):
            g = dist.new_group([d * m + i for d in range(n_data)],
                               timeout=TIMEOUT)
            if i == rank % m:
                data_group = g
    from torch.distributed.device_mesh import DeviceMesh
    model_mesh = DeviceMesh.from_group(model_group, dev.type,
                                       mesh_dim_names=("model",))
    return ReplicaMesh({"data": n_data, "model": m}, rank, world, group, dev,
                       owns_group=owns, data_group=data_group,
                       model_group=model_group, model_mesh=model_mesh)


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
    """The global indices of this rank's contiguous chunk of replicas:
    the chunk of its data index (the ranks of one replica's model axis
    hold the same replicas)."""
    n_data = mesh.world // mesh.model_size
    per = n_replicas // n_data
    return range(mesh.data_index * per, (mesh.data_index + 1) * per)
