"""Sharding rules: parameter tree -> spec tree (port of
``repro/launch/sharding.py``).

Rules are path-based (megatron-style tensor parallel over the ``model``
axis) with divisibility guards: a dim is sharded only if the axis size
divides it, otherwise it stays replicated.  A spec is a plain tuple with
one entry per dim of its leaf: ``None`` (replicated), an axis name
(``"model"``, ``"data"``) or a tuple of axis names, as the entries of the
reference's ``PartitionSpec``.  A spec tree has the structure of the tree
it describes, with a spec tuple at each leaf; ``flat_specs`` lists its
(path, spec) pairs in leaf order, and ``placements`` turns a spec into
DTensor placements on the replica's one-dimensional ``model`` mesh (the
reference's ``named``).

A mesh here is anything with axis sizes: a ``launch.mesh.ReplicaMesh``
(its ``shape``) or a plain ``{axis: size}`` dict.

Plans (the reference's DESIGN.md §4):
  replica_dp — params gain a leading replica axis sharded over data (+pod);
  fsdp       — params additionally shard their largest replicated dim over
               ``data``; the replica axis (if any) maps to ``pod``;
  replica_ddp — params fully replicated inside a replica group.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Mapping, Tuple

from repro_torch.configs.base import ModelConfig, ParallelismPlan

Pytree = Any
Spec = Tuple


def _axis_size(mesh, name: str) -> int:
    sizes = mesh if isinstance(mesh, Mapping) else mesh.shape
    return dict(sizes).get(name, 1)


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


# ---------------------------------------------------------------------------
# Base (unstacked, tensor-parallel) rules
# ---------------------------------------------------------------------------

# (path regex, callable(shape, msize) -> spec tuple over the param's own dims)
def _rules(cfg: ModelConfig, vocab_parallel: bool = True):
    def col(shape, m):      # shard last dim (output features)
        return (None,) * (len(shape) - 1) + ("model" if _div(shape[-1], m) else None,)

    def row(shape, m):      # shard first dim (input features)
        return ("model" if _div(shape[0], m) else None,) + (None,) * (len(shape) - 1)

    def expert(shape, m):   # (E, D, F): expert-parallel if E divides, else F
        if _div(shape[0], m):
            return ("model", None, None)
        if _div(shape[-1], m):
            return (None, None, "model")
        return (None, None, None)

    def expert_row(shape, m):  # (E, F, D)
        if _div(shape[0], m):
            return ("model", None, None)
        if _div(shape[1], m):
            return (None, "model", None)
        return (None, None, None)

    def rep(shape, m):
        return (None,) * len(shape)

    def emb(shape, m):
        # vocab-parallel embedding (megatron); falls back to d_model
        # sharding for odd vocab sizes
        if vocab_parallel and _div(shape[0], m):
            return ("model", None)
        return (None, "model" if _div(shape[1], m) else None)

    return [
        (r"embed$", emb),
        (r"lm_head$", col),
        (r"\bwq\|w$|\bwk\|w$|\bwv\|w$", col),
        (r"\bwq\|b$|\bwk\|b$|\bwv\|b$", col),
        (r"\bwo\|w$", row),
        (r"wkv_a\|w$", rep),            # small latent projections (MLA)
        (r"wkv_b\|w$", col),
        (r"wq_a\|w$", rep),
        (r"w_gate\|w$|w_up\|w$|ff_gate$|ff_up$", col),
        (r"w_down\|w$|ff_down$", row),
        (r"moe\|router$", rep),
        (r"moe\|w_gate$|moe\|w_up$", expert),
        (r"moe\|w_down$", expert_row),
        (r"in_proj$|\bup$|\bwx$", col),
        (r"out_proj$|\bdown$", row),
        (r"x_proj$|A_log$|dt_proj_b$|\bD$", row),
        (r"dt_proj_w$", col),
        (r"conv_w$|conv_b$", col),
        (r"w_if$|b_i$|b_f$|ogate_norm$|\br$|\bgn$", rep),
        # the compact CNN: conv output channels and fc1 columns shard over
        # 'model', fc2 rows contract over it
        (r"convs\|#\d+\|[wb]$", col),
        (r"fc1\|[wb]$", col),
        (r"fc2\|w$", row),
        (r".*", rep),                   # norms, biases, scalars
    ]


# ---------------------------------------------------------------------------
# Paths over the port's trees
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _walk(tree, path: Tuple[str, ...], fn: Callable, is_leaf=None):
    """``fn(path_str, leaf)`` over the leaves of ``tree`` in
    ``tree_leaves`` order (dict keys sorted, sequences in order); the
    containers are rebuilt."""
    if is_leaf is not None and is_leaf(tree):
        return fn("|".join(path), tree)
    if isinstance(tree, dict):
        return {k: _walk(tree[k], path + (str(k),), fn, is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_walk(x, path + (f"#{i}",), fn, is_leaf)
               for i, x in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn("|".join(path), tree)


def tree_map_with_path(fn: Callable, tree: Pytree) -> Pytree:
    """``fn(path_str, leaf)`` over every leaf; the path strings are the
    reference's (``blocks|#0|attn|wq|w``, ``convs|#1|w``)."""
    return _walk(tree, (), fn)


def tree_paths(tree: Pytree) -> List[str]:
    """The path string of each leaf, in ``tree_leaves`` order."""
    out: List[str] = []
    _walk(tree, (), lambda p, x: out.append(p))
    return out


def flat_specs(spec_tree: Pytree) -> List[Tuple[str, Spec]]:
    """(path, spec) of each leaf of a spec tree, in leaf order."""
    out: List[Tuple[str, Spec]] = []
    _walk(spec_tree, (), lambda p, s: out.append((p, s)), is_leaf=_is_spec)
    return out


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def base_spec(cfg: ModelConfig, path_s: str, shape: Tuple[int, ...],
              mesh, plan: ParallelismPlan) -> Spec:
    m = _axis_size(mesh, "model")
    if plan.plan == "replica_ddp":
        # the 'model' axis as extra data parallelism inside each replica
        # group: params fully replicated
        return (None,) * len(shape)
    spec: Spec = ()
    for pat, fn in _rules(cfg, plan.vocab_parallel_embed):
        if re.search(pat, path_s):
            spec = fn(shape, m)
            break
    if plan.plan == "fsdp":
        d = _axis_size(mesh, "data")
        # shard the largest still-replicated dim over 'data' (zero-3 style)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and _div(shape[i], d) and shape[i] >= d:
                spec = spec[:i] + ("data",) + spec[i + 1:]
                break
    return spec


def _replica_spec_entry(replica_axes: Tuple[str, ...]):
    if not replica_axes:
        return None
    return replica_axes if len(replica_axes) > 1 else replica_axes[0]


def param_specs(cfg: ModelConfig, params: Pytree, mesh,
                plan: ParallelismPlan, *, replica_axes: Tuple[str, ...] = (),
                stacked: bool = False) -> Pytree:
    """Spec tree for (possibly replica-stacked) params; only the leaves'
    shapes are read (tensors on any device, the meta device too).
    ``stacked``: leaves carry a leading replica dim (sharded over
    ``replica_axes``; replicated if it is empty)."""
    def one(ps, x):
        shape = tuple(x.shape[1:] if stacked else x.shape)
        spec = base_spec(cfg, ps, shape, mesh, plan)
        if stacked:
            spec = (_replica_spec_entry(replica_axes),) + spec
        return spec
    return tree_map_with_path(one, params)


def opt_specs(cfg: ModelConfig, opt_state: Pytree, param_spec_tree: Pytree,
              mesh, plan: ParallelismPlan,
              replica_axes: Tuple[str, ...] = (),
              stacked: bool = False) -> Pytree:
    """Optimizer state mirrors parameter sharding (buffers have identical
    shapes); scalars (step counters) are replicated."""
    flat_params = dict(flat_specs(param_spec_tree))

    def one(ps, x):
        # state trees have structure {m: <params-tree>}: strip the leading
        # state key and reuse the matching param's spec directly
        inner = ps.split("|", 1)[1] if "|" in ps else ps
        if inner in flat_params:
            return flat_params[inner]
        shape = tuple(x.shape[1:] if stacked else x.shape)
        if len(shape) == 0:
            if stacked and x.ndim == 1:   # replicated step counter per lane
                return (_replica_spec_entry(replica_axes),)
            return ()
        spec = base_spec(cfg, ps, shape, mesh, plan)
        if stacked:
            spec = (_replica_spec_entry(replica_axes),) + spec
        return spec
    return tree_map_with_path(one, opt_state)


def cache_specs(cfg: ModelConfig, caches: Pytree, mesh, *,
                batch: int) -> Pytree:
    """KV caches / SSM states for serving.  Batch dim shards over 'data'
    when divisible; otherwise (long-context B=1) the sequence dim shards
    over 'data' (flash-decoding style) and heads/channels over 'model'."""
    d = _axis_size(mesh, "data")
    m = _axis_size(mesh, "model")
    batch_shardable = _div(batch, d)

    def one(ps, x):
        shape = tuple(x.shape)
        ndim = len(shape)
        if ndim == 0 or ps.endswith("index"):
            return ()
        b_ax = "data" if batch_shardable else None
        if ps.endswith("|k") or ps.endswith("|v"):      # (B,S,K,dh)
            s_ax = None if batch_shardable else "data"
            if not _div(shape[1], d):
                s_ax = None
            h_ax = "model" if _div(shape[2], m) else None
            return (b_ax, s_ax, h_ax, None)
        if ps.endswith("|pos"):                          # (B,S)
            s_ax = None if batch_shardable else ("data" if _div(shape[1], d) else None)
            return (b_ax, s_ax)
        if ps.endswith("|ckv") or ps.endswith("|kpe"):   # (B,S,r) MLA latent
            s_ax = None if batch_shardable else ("data" if _div(shape[1], d) else None)
            return (b_ax, s_ax, None)
        if ps.endswith("|ssm"):                          # (B,Di,N)
            return (b_ax, "model" if _div(shape[1], m) else None, None)
        if ps.endswith("|conv"):                         # (B,K-1,Di)
            return (b_ax, None, "model" if _div(shape[2], m) else None)
        if ps.endswith("|C"):                            # mlstm (B,H,dh,dh)
            return (b_ax, "model" if _div(shape[1], m) else None, None, None)
        if ps.endswith("|n") or ps.endswith("|m"):       # (B,H,dh)/(B,H)
            h_ax = "model" if (ndim > 1 and _div(shape[1], m)) else None
            return (b_ax, h_ax) + (None,) * (ndim - 2)
        if ndim >= 2:                                    # slstm (B,D) etc.
            return (b_ax, "model" if _div(shape[1], m) else None) \
                + (None,) * (ndim - 2)
        return (b_ax,)
    return tree_map_with_path(one, caches)


def model_dim(spec: Spec):
    """The dim a spec shards over ``model`` (the rules shard at most one),
    or None."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


def placements(spec: Spec, *, stacked: bool = False):
    """The reference's ``named``: DTensor placements of a leaf on the
    replica's ``model`` mesh, ``[Shard(d)]`` where the spec names
    ``model`` at dim d of the leaf's own dims (after the replica dim
    when ``stacked``), else ``[Replicate()]``."""
    from torch.distributed.tensor import Replicate, Shard
    d = model_dim(spec[1:] if stacked else spec)
    return [Replicate()] if d is None else [Shard(d)]
