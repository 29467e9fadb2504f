"""Tensor parallelism inside one replica: the mesh's ``replica_tp``
placement (the reference leaves it to GSPMD, ``auto={'model'}``).

A rank stores its local shard of every stacked leaf as a plain tensor,
cut by the spec rules of ``launch/sharding.py``; ``Layout`` keeps, per
leaf path, the dim the ``model`` axis shards (in the stacked leaf) and
the size of that dim in the whole leaf.  The syncs, the kernels, the
optimizer and the checkpoints work on the plain shards.  Only the local
step's forward and backward see DTensors: ``ModelShards.value_and_grad``
wraps each of a replica's views with ``DTensor.from_local`` on the
one-dimensional ``model`` mesh, under ``implicit_replication`` (the
batch, masks, positions and tables the model makes are ``Replicate``),
and takes ``torch.autograd.grad`` with respect to the local views, so the
gradients come back as local shards through ``from_local``'s autograd.

Where DTensor cannot shard a torch function of the forward (an op with no
strategy, or ``torch.einsum``, whose reshapes flatten a sharded dim with
others, which torch 2.11 refuses), ``WholeWhereRefused`` runs it on whole
plain tensors, its outputs ``Replicate``.  Below autograd, DTensor has no
usable rule for a few ops the families need:
``aten.convolution`` / ``convolution_backward`` (its handler assumes an
input sharded over the width and a replicated weight, not output
channels), ``aten.index.Tensor`` and ``aten.gather`` on a sharded dim
(the masked partial result fails to mask a lookup of more than one
index dim), ``aten.scatter_add`` (gather's backward, given a plain
index) and ``aten.argmax`` (a decode step's greedy pick over
vocab-sharded logits: torch 2.13's handler fails to reshape its gather
at one row a rank).  ``install_fallbacks`` makes DTensor redistribute
every operand of these to ``Replicate`` and run the op on whole tensors.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.launch import sharding as shard_rules
from repro_torch.runtime import phases
from repro_torch.tree import tree_leaves, tree_unflatten

FALLBACK_OPS = ("convolution.default", "convolution_backward.default",
                "index.Tensor", "gather.default", "scatter_add.default",
                "argmax.default")
_installed = [False]


def install_fallbacks() -> None:
    """Route ``FALLBACK_OPS`` on DTensors through whole (``Replicate``)
    operands; idempotent."""
    if _installed[0]:
        return
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Replicate

    def replicated(op_call, args, kwargs):
        mesh = []

        def local(x):
            if not isinstance(x, DTensor):
                return x
            mesh.append(x.device_mesh)
            if x.device_mesh.size() == 1:
                # one rank: its local tensor is the whole one, whatever
                # the placement
                return x._local_tensor
            return x.redistribute(x.device_mesh, [Replicate()]).to_local()
        args, kwargs = pytree.tree_map(local, (args, kwargs))
        out = op_call(*args, **kwargs)
        return pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh[0], [Replicate()],
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    handlers = DTensor._op_dispatcher._custom_op_handlers
    aten = torch.ops.aten
    for name in FALLBACK_OPS:
        packet, overload = name.split(".")
        handlers[getattr(getattr(aten, packet), overload)] = replicated
    _installed[0] = True


_REFUSALS = ("does not have a sharding strategy", "Sharding propagation failed",
             "without redistribution")


def _refused(err: Exception) -> bool:
    return any(r in str(err) for r in _REFUSALS)


def _dtensors(args, kwargs):
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor
    return [x for x in pytree.tree_leaves((args, kwargs))
            if isinstance(x, DTensor)]


def _run_whole(func, args, kwargs):
    """``func`` on whole plain tensors (each DTensor operand's
    ``full_tensor()``), its tensor outputs ``Replicate`` DTensors; both
    conversions are differentiable, so its backward runs on plain
    tensors too."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _dtensors(args, kwargs)[0].device_mesh
    args, kwargs = pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x,
        (args, kwargs))
    out = func(*args, **kwargs)
    return pytree.tree_map(
        lambda t: DTensor.from_local(t, mesh, [Replicate()], run_check=False)
        if isinstance(t, torch.Tensor) else t, out)


class WholeWhereRefused(TorchFunctionMode):
    """A torch-function mode, entered around a replica's forward.  Each
    function runs as DTensor shards it, but on whole operands where
    DTensor cannot: ``torch.einsum`` with a sharded operand (its reshapes
    flatten the sharded head dim with others, which torch 2.11's DTensor
    refuses, in the backward too), and any function whose sharding
    propagation DTensor refuses (no strategy; it fails before any
    collective or write, on every rank alike, so running it again is
    safe).  ``whole`` counts those functions by name."""

    def __init__(self, whole: Counter):
        super().__init__()
        self.whole = whole

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum and any(
                not p.is_replicate() for x in _dtensors(args, kwargs)
                for p in x.placements):
            self.whole["einsum"] += 1
            return _run_whole(func, args, kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as err:
            if not _refused(err) or not _dtensors(args, kwargs):
                raise
            self.whole[getattr(func, "__name__", str(func))] += 1
            return _run_whole(func, args, kwargs)


class Layout:
    """The ``model`` sharding of a backend's stacked trees: each leaf's
    stacked spec by path, whose ``model`` entry names the dim the model
    axis shards (none: every model rank holds the leaf whole).  The rules
    shard a dim only where m divides it, so a shard is 1/m of it."""

    def __init__(self, m: int, index: int):
        self.m, self.index = m, index
        self.specs: Dict[str, tuple] = {}

    def record(self, spec_tree) -> None:
        """Keep each leaf's stacked spec, by path."""
        self.specs.update(shard_rules.flat_specs(spec_tree))

    def specs_of(self, tree) -> List[tuple]:
        """Each leaf's stacked spec (a leaf never recorded: whole)."""
        return [self.specs.get(p, ()) for p in shard_rules.tree_paths(tree)]

    def dims_of(self, tree) -> List[Optional[int]]:
        return [shard_rules.model_dim(s) for s in self.specs_of(tree)]

    def cut(self, x: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        """This rank's shard of a whole leaf along d (a view)."""
        if d is None or self.m == 1:
            return x
        n = x.shape[d] // self.m
        return x.narrow(d, self.index * n, n)

    def whole_shapes(self, tree) -> List[Tuple[int, ...]]:
        """The whole shape of each leaf of a tree of shards."""
        out = []
        for x, d in zip(tree_leaves(tree), self.dims_of(tree)):
            s = list(x.shape)
            if d is not None:
                s[d] *= self.m
            out.append(tuple(s))
        return out


class ModelShards:
    """The local step's view of one replica spread over the ``model``
    mesh: its leaves' placements (from the layout's dims, read off the
    stacked tree's paths once), the DTensor forward and backward, the
    gradient norm over the model group and the whole leaves a quantized
    exchange needs."""

    def __init__(self, layout: Layout, model_mesh, model_group,
                 whole: Counter):
        install_fallbacks()
        self.layout, self.mesh, self.group = layout, model_mesh, model_group
        self._whole_calls = whole
        self._dims: Optional[List[Optional[int]]] = None

    def bind(self, W) -> "ModelShards":
        """Read the stacked tree's specs (once: the trees a step sees keep
        their structure): the sharded dims and the DTensor placements."""
        if self._dims is None:
            specs = self.layout.specs_of(W)
            self._dims = [shard_rules.model_dim(s) for s in specs]
            self._placements = [shard_rules.placements(s, stacked=True)
                                for s in specs]
        return self

    def _replica_dims(self) -> List[Optional[int]]:
        return [None if d is None else d - 1 for d in self._dims]

    def value_and_grad(self, loss_fn, live, batch):
        """(loss, aux, grads) of one replica: ``live`` its local shards
        (fresh leaves requiring grad), each wrapped as a DTensor of its
        placement; the loss and aux come back whole and plain, the
        gradients as local shards; the phases forward and backward in the
        running program's ``runtime/phases.py`` recorder."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        leaves = tree_leaves(live)
        dts = [DTensor.from_local(x, self.mesh, pl, run_check=False)
               for x, pl in zip(leaves, self._placements)]

        def plain(v):
            return v.full_tensor() if isinstance(v, DTensor) else v
        phase = phases.current().phase
        with implicit_replication():
            with phase("forward"):
                with WholeWhereRefused(self._whole_calls):
                    loss, aux = loss_fn(tree_unflatten(live, dts), batch)
                loss = plain(loss)
                aux = {k: plain(v) for k, v in aux.items()}
            with phase("backward"):
                grads = torch.autograd.grad(loss, leaves)
        return loss, aux, grads

    def grad_sqnorm(self, grads) -> torch.Tensor:
        """Σ ||g||² over the whole replica: each rank's shards, a
        replicated leaf counted by model index 0 alone, summed over the
        model group (in the ``vmap`` backend's order at m = 1)."""
        first = self.layout.index == 0
        s = sum(g.to(torch.float32).square().sum()
                for g, d in zip(grads, self._replica_dims())
                if first or d is not None)
        if not isinstance(s, torch.Tensor):
            s = torch.zeros((), dtype=torch.float32,
                            device=grads[0].device)
        s = s.reshape(1)
        dist.all_reduce(s, group=self.group)
        return s[0]

    def whole(self, leaves: List[torch.Tensor], stacked: bool = False
              ) -> List[torch.Tensor]:
        """The whole leaves from every model rank's shards of ``leaves``
        (one replica's, or stacked ones): one ``all_gather`` over the
        model group per dtype; the leaves themselves at m = 1."""
        dims = self._dims if stacked else self._replica_dims()
        return gather_model(leaves, dims, self.layout.m, self.group)

    def cut_leaf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of replica leaf i, whole in ``x`` (a copy;
        ``x`` itself at m = 1)."""
        d = self._dims[i]
        return self.layout.cut(x, None if d is None else d - 1).contiguous()


def gather_model(leaves: List[torch.Tensor], dims, m: int, group
                 ) -> List[torch.Tensor]:
    """Whole leaves from the m model ranks' shards (sharded along each
    leaf's dim in ``dims``; None: held whole already), bucketed: one
    ``all_gather_into_tensor`` per dtype over ``group``."""
    if m == 1:
        return list(leaves)
    out = list(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (x, d) in enumerate(zip(leaves, dims)):
        if d is not None:
            by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        sizes = [leaves[i].numel() for i in idx]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        got = torch.empty(m * flat.numel(), dtype=dtype, device=flat.device)
        dist.all_gather_into_tensor(got, flat, group=group)
        parts = got.view(m, -1).split(sizes, dim=1)
        for i, part in zip(idx, parts):
            x, d = leaves[i], dims[i]
            out[i] = torch.cat([p.reshape(x.shape) for p in part.unbind(0)],
                               dim=d)
    return out
