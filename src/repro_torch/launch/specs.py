"""Abstract inputs of every (architecture x input shape) pair and their
sharding specs (port of ``repro/launch/specs.py``): tensors on the meta
device (shapes and dtypes, no storage) in place of the reference's
``ShapeDtypeStruct``, and specs as the plain tuples of
``launch/sharding.py`` in place of its ``PartitionSpec``.  This is what
the dry run (``launch/dryrun.py``) builds its programs on.

A mesh here is anything with axis sizes: a ``launch.mesh.ReplicaMesh`` or
a plain ``{axis: size}`` dict.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.sharding import _axis_size

Pytree = Any


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape, n_replicas: int,
                      plan: str = "replica_dp",
                      replica_axes: Tuple[str, ...] = None,
                      ) -> Tuple[Pytree, Pytree]:
    """Replica-stacked training batch: (tensors, specs).  Leaves carry
    (R, per_replica_batch, ...).  The leading dim shards over
    ``replica_axes`` (the mesh axes the plan gives the replicas); within
    a replica group the batch shards over 'data' (fsdp) or 'model'
    (replica_ddp, when the per-replica batch is a multiple of 16)."""
    R = n_replicas
    b = max(1, shape.global_batch // R)
    S = shape.seq_len
    if replica_axes is None:            # the reference's legacy heuristic
        replica_axes = ("pod", "data") if R > 16 else (
            ("data",) if R > 1 else ())
    rep_ax: Any = (None if not replica_axes else
                   (replica_axes if len(replica_axes) > 1 else replica_axes[0]))
    dp_ax = None
    if plan == "fsdp":
        dp_ax = "data"
    elif plan == "replica_ddp" and b % 16 == 0:
        dp_ax = "model"
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    if cfg.vision is not None:
        Pv = cfg.vision.n_patches
        batch["tokens"] = _meta((R, b, S - Pv), torch.int32)
        batch["vision_embeds"] = _meta((R, b, Pv, cfg.d_model), torch.bfloat16)
        batch["mrope_pos"] = _meta((R, 3, b, S), torch.int32)
        specs["tokens"] = (rep_ax, dp_ax, None)
        specs["vision_embeds"] = (rep_ax, dp_ax, None, None)
        specs["mrope_pos"] = (rep_ax, None, dp_ax, None)
    else:
        batch["tokens"] = _meta((R, b, S), torch.int32)
        specs["tokens"] = (rep_ax, dp_ax, None)
    if cfg.encoder is not None:
        T = cfg.encoder.n_frames
        batch["frames"] = _meta((R, b, T, cfg.d_model), torch.bfloat16)
        specs["frames"] = (rep_ax, dp_ax, None, None)
    return batch, specs


def _batch_axis(B: int, mesh):
    d = _axis_size(mesh, "data")
    return "data" if B % d == 0 and B >= d else None


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                        ) -> Tuple[Pytree, Pytree]:
    B, S = shape.global_batch, shape.seq_len
    b_ax = _batch_axis(B, mesh)
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    if cfg.vision is not None:
        Pv = cfg.vision.n_patches
        batch["tokens"] = _meta((B, S - Pv), torch.int32)
        batch["vision_embeds"] = _meta((B, Pv, cfg.d_model), torch.bfloat16)
        batch["mrope_pos"] = _meta((3, B, S), torch.int32)
        specs["tokens"] = (b_ax, None)
        specs["vision_embeds"] = (b_ax, None, None)
        specs["mrope_pos"] = (None, b_ax, None)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        specs["tokens"] = (b_ax, None)
    if cfg.encoder is not None:
        T = cfg.encoder.n_frames
        batch["frames"] = _meta((B, T, cfg.d_model), torch.bfloat16)
        specs["frames"] = (b_ax, None, None)
    return batch, specs


def decode_batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                       ) -> Tuple[Pytree, Pytree]:
    B = shape.global_batch
    b_ax = _batch_axis(B, mesh)
    batch: Dict[str, Any] = {"tokens": _meta((B, 1), torch.int32)}
    specs: Dict[str, Any] = {"tokens": (b_ax, None)}
    if cfg.encoder is not None:
        T = cfg.encoder.n_frames
        batch["encoder_out"] = _meta((B, T, cfg.d_model), torch.bfloat16)
        specs["encoder_out"] = (b_ax, None, None)
    return batch, specs


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> Pytree:
    from repro_torch.models import model as M
    return M.init_caches(cfg, batch, max_len, dtype=torch.bfloat16,
                         device="meta")


def abstract_params(cfg: ModelConfig, n_replicas: int = 0) -> Pytree:
    """The init's parameter tree on the meta device (stacked over
    ``n_replicas`` when given)."""
    from repro_torch.core.averaging import stack_replicas
    from repro_torch.models import model as M
    p = M.init_params(0, cfg, device="meta")
    return stack_replicas(p, n_replicas) if n_replicas else p


def abstract_opt_state(opt, params_abs: Pytree, stacked: bool) -> Pytree:
    from repro_torch.core.averaging import n_replicas
    return opt.init(params_abs,
                    n_replicas=n_replicas(params_abs) if stacked else None)
