"""The paper's core: periodic parameter averaging over a stacked replica
axis (port of ``repro/core/averaging.py``).

``W`` is a parameter tree whose every leaf carries a leading replica axis of
size R — one local-SGD trajectory per replica.  ``make_local_step`` advances
each replica on its own batch shard with no exchange between them
(Algorithm 1 lines 3–4); ``sync_replicas`` is the one program that mixes
replicas: the parameter mean plus the variance probe
``S_k = (1/R) Σ_i ||w̄ − w_i||²`` (Algorithm 2 lines 10–11).

The reference ``vmap``s one replica's program over the axis; here the local
step loops over the R replicas, each on views of the stacked buffers, with
``torch.autograd.grad`` per replica — the same maths, and only one
replica's gradients are alive at a time.  Programs update W and the
optimizer state in place and return them.

Under the mesh's ``replica_tp`` placement W holds this rank's shards of
each replica, and the step programs take ``tp`` (``backends/tp.py``'s
``ModelShards``): its ``value_and_grad`` runs the replica's forward and
backward on DTensors, and its ``grad_sqnorm`` sums the gradient norm over
the model group.

The step programs mark three phases a replica in the recorder of the
running program (``runtime/phases.py``; the backend binds it): ``forward``
(the loss), ``backward`` (``torch.autograd.grad``, remat's recompute
included) and ``optimizer`` (the update, and the gradient norm of the
local step).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import phases
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any
LossFn = Callable[[Pytree, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict]]
# (this process's f32 gradient sums, its metrics) -> (the sums over every
# replica, the metrics' mean over every replica, R)
Exchange = Callable[[List[torch.Tensor], Dict[str, torch.Tensor]],
                    Tuple[List[torch.Tensor], Dict[str, torch.Tensor], int]]


def stack_replicas(tree: Pytree, n: int) -> Pytree:
    """Replicate a single-model tree into n identical local trajectories
    (contiguous copies)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape)
                    .contiguous(), tree)


def replica_mean(W: Pytree) -> Pytree:
    return tree_map(lambda x: x.mean(dim=0), W)


def n_replicas(W: Pytree) -> int:
    return tree_leaves(W)[0].shape[0]


def replica_view(tree: Pytree, r: int) -> Pytree:
    """Replica r of a stacked tree, as views: writing into them writes
    into the stacked buffers."""
    return tree_map(lambda x: x[r], tree)


def parameter_variance(W: Pytree) -> torch.Tensor:
    """Var[W_k] = (1/n) Σ_i ||W̄ − w_i||²  (paper Eq. 7), summed over the
    entire parameter vector, in float32."""
    leaves = tree_leaves(W)
    return sync_to(leaves, leaf_means(leaves), write=False)


def leaf_means(leaves):
    """Each stacked leaf's replica mean in f32, one leaf at a time."""
    return (x.to(torch.float32).mean(dim=0) for x in leaves)


@torch.no_grad()
def sync_to(leaves, means, *, write: bool = True, count=None) -> torch.Tensor:
    """The plain sync against given f32 means (one per stacked leaf, its
    replica shape): Σ_l Σ_i ||w_i − m_l||² / R_l, with each m_l written
    into every replica of its leaf when ``write``.  With each leaf's own
    mean it is the plain route of ``sync_replicas`` and
    ``parameter_variance``; the mesh backend gives it the mean over every
    process.  ``count``: one bool a leaf, whether it enters the sum (a
    leaf a model rank holds whole enters one rank's sum alone)."""
    S_k = 0
    for i, (x, m) in enumerate(zip(leaves, means)):
        m = m.unsqueeze(0)
        if count is None or count[i]:
            S_k = S_k + (x.to(torch.float32) - m).square().sum() / x.shape[0]
        if write:
            x.copy_(m.expand_as(x))
    if not isinstance(S_k, torch.Tensor):          # no leaf counted
        S_k = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return S_k


def value_and_grad(loss_fn: LossFn, params: Pytree, batch, tp=None):
    """(loss, aux, grads) of ``loss_fn`` at ``params``; the parameters are
    taken as fresh leaves sharing their storage, so ``params`` may be views
    of a stacked buffer (a rank's shards of them with ``tp``)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if tp is None:
            phase = phases.current().phase
            with phase("forward"):
                loss, aux = loss_fn(live, batch)
            with phase("backward"):
                grads = torch.autograd.grad(loss, tree_leaves(live))
        else:
            loss, aux, grads = tp.value_and_grad(loss_fn, live, batch)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree_unflatten(params, list(grads))


def make_replica_step(loss_fn: LossFn, optimizer: Optimizer, tp=None):
    """The single-replica program one_replica(params, opt_state, batch, lr)
    -> (params, opt_state, metrics), on one replica's views."""

    def one_replica(params, opt_state, batch, lr):
        loss, aux, grads = value_and_grad(loss_fn, params, batch, tp)
        with torch.no_grad(), phases.current().phase("optimizer"):
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
            if tp is None:
                sq = sum(g.to(torch.float32).square().sum()
                         for g in tree_leaves(grads))
            else:
                sq = tp.grad_sqnorm(tree_leaves(grads))
            gnorm = torch.sqrt(sq)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    return one_replica


def _mean_metrics(per_replica):
    return {k: torch.stack([m[k] for m in per_replica]).mean(dim=0)
            for k in per_replica[0]}


def make_local_step(loss_fn: LossFn, optimizer: Optimizer, tp=None):
    """Returns step(W, opt_state, batch, lr) -> (W, opt_state, metrics).
    ``batch`` leaves carry the replica axis (R, per_replica_batch, ...);
    metrics are averaged over the replicas."""
    one_replica = make_replica_step(loss_fn, optimizer, tp)

    def step(W, opt_state, batch, lr):
        if tp is not None:
            tp.bind(W)
        metrics = []
        for r in range(n_replicas(W)):
            _, _, m = one_replica(replica_view(W, r),
                                  replica_view(opt_state, r),
                                  replica_view(batch, r), lr)
            metrics.append(m)
        return W, opt_state, _mean_metrics(metrics)

    return step


@torch.no_grad()
def sync_replicas(W: Pytree, opt_state: Optional[Pytree] = None, *,
                  sync_momentum: bool = False,
                  use_kernel: bool = False,
                  ) -> Tuple[Pytree, Optional[Pytree], torch.Tensor]:
    """Average the replicas (Algorithm 2 line 10) and compute the variance
    probe S_k (line 11).  Returns (W_synced, opt_state, S_k).

    The mean is written back into every replica of the stacked buffers in
    place, which saves the parameter-sized copy the reference's broadcast
    makes; W_synced is W.  ``use_kernel`` runs the fused mean + sqdev
    kernel once over all leaves in its sync mode, which writes the mean
    back itself (the reference runs its kernel once per leaf)."""
    leaves = tree_leaves(W)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        _, S_k = kops.param_mean_and_sqdev_many(leaves, "sync")
    else:
        S_k = sync_to(leaves, leaf_means(leaves))
    if opt_state is not None and sync_momentum:
        opt_state = sync_opt_state(opt_state)
    return W, opt_state, S_k


@torch.no_grad()
def group_sync(W: Pytree, group_size: int) -> Pytree:
    """Hierarchical (beyond-paper): average only within contiguous groups
    of ``group_size`` replicas (one pod), in place: each leaf is viewed as
    (R // g, g, ...), meaned over the group axis in f32 and written back.
    Cross-group averaging is left to the outer adaptive schedule."""
    for x in tree_leaves(W):
        g = x.view(x.shape[0] // group_size, group_size, *x.shape[1:])
        m = g.to(torch.float32).mean(dim=1, keepdim=True)
        g.copy_(m.expand_as(g))
    return W


@torch.no_grad()
def sync_opt_state(opt_state: Pytree) -> Pytree:
    """Average the optimizer state across replicas, in place (beyond-paper
    knob)."""
    for x in tree_leaves(opt_state):
        x.copy_(x.to(torch.float32).mean(dim=0, keepdim=True).expand_as(x))
    return opt_state


def make_full_step(loss_fn: LossFn, optimizer: Optimizer,
                   exchange: Optional[Exchange] = None, tp=None):
    """FULLSGD baseline: gradients are averaged across replicas every step
    (vanilla synchronous data-parallel SGD).  ``exchange`` (the mesh
    backend's) sums the replicas' gradients over the processes; without
    it W holds every replica."""

    def step(W, opt_state, batch, lr):
        R = n_replicas(W)
        if tp is not None:
            tp.bind(W)
        g_sum, losses, auxs = None, [], []
        for r in range(R):
            loss, aux, grads = value_and_grad(
                loss_fn, replica_view(W, r), replica_view(batch, r), tp)
            gf = [g.to(torch.float32) for g in tree_leaves(grads)]
            g_sum = gf if g_sum is None else [a + b for a, b in zip(g_sum, gf)]
            losses.append(loss)
            auxs.append(aux)
        metrics = {"loss": torch.stack(losses).mean(),
                   **(_mean_metrics(auxs) if auxs[0] else {})}
        n = R
        if exchange is not None:
            g_sum, metrics, n = exchange(g_sum, metrics)
        g_mean = tree_unflatten(
            replica_view(W, 0),
            [(g / n).to(p.dtype) for g, p in
             zip(g_sum, tree_leaves(replica_view(W, 0)))])
        with torch.no_grad(), phases.current().phase("optimizer"):
            for r in range(R):
                optimizer.update(g_mean, replica_view(opt_state, r),
                                 replica_view(W, r), lr)
        return W, opt_state, metrics

    return step
