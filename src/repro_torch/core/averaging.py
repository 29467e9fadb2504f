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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any
LossFn = Callable[[Pytree, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict]]


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
    def leaf_var(x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=0, keepdim=True)
        return (xf - mean).square().sum() / x.shape[0]
    return sum(leaf_var(x) for x in tree_leaves(W))


def value_and_grad(loss_fn: LossFn, params: Pytree, batch):
    """(loss, aux, grads) of ``loss_fn`` at ``params``; the parameters are
    taken as fresh leaves sharing their storage, so ``params`` may be views
    of a stacked buffer."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree_unflatten(params, list(grads))


def make_replica_step(loss_fn: LossFn, optimizer: Optimizer):
    """The single-replica program one_replica(params, opt_state, batch, lr)
    -> (params, opt_state, metrics), on one replica's views."""

    def one_replica(params, opt_state, batch, lr):
        loss, aux, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
            gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum()
                                   for g in tree_leaves(grads)))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    return one_replica


def _mean_metrics(per_replica):
    return {k: torch.stack([m[k] for m in per_replica]).mean(dim=0)
            for k in per_replica[0]}


def make_local_step(loss_fn: LossFn, optimizer: Optimizer):
    """Returns step(W, opt_state, batch, lr) -> (W, opt_state, metrics).
    ``batch`` leaves carry the replica axis (R, per_replica_batch, ...);
    metrics are averaged over the replicas."""
    one_replica = make_replica_step(loss_fn, optimizer)

    def step(W, opt_state, batch, lr):
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
    R = leaves[0].shape[0]
    if use_kernel:
        from repro_torch.kernels import ops as kops
        _, S_k = kops.param_mean_and_sqdev_many(leaves, "sync")
    else:
        S_k = 0
        for x in leaves:
            m = x.to(torch.float32).mean(dim=0, keepdim=True)
            S_k = S_k + (x.to(torch.float32) - m).square().sum() / R
            x.copy_(m.expand_as(x))
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


def make_full_step(loss_fn: LossFn, optimizer: Optimizer):
    """FULLSGD baseline: gradients are averaged across replicas every step
    (vanilla synchronous data-parallel SGD)."""

    def step(W, opt_state, batch, lr):
        R = n_replicas(W)
        g_sum, losses, auxs = None, [], []
        for r in range(R):
            loss, aux, grads = value_and_grad(
                loss_fn, replica_view(W, r), replica_view(batch, r))
            gf = [g.to(torch.float32) for g in tree_leaves(grads)]
            g_sum = gf if g_sum is None else [a + b for a, b in zip(g_sum, gf)]
            losses.append(loss)
            auxs.append(aux)
        g_mean = tree_unflatten(
            replica_view(W, 0),
            [(g / R).to(p.dtype) for g, p in
             zip(g_sum, tree_leaves(replica_view(W, 0)))])
        with torch.no_grad():
            for r in range(R):
                optimizer.update(g_mean, replica_view(opt_state, r),
                                 replica_view(W, r), lr)
        metrics = {"loss": torch.stack(losses).mean(),
                   **(_mean_metrics(auxs) if auxs[0] else {})}
        return W, opt_state, metrics

    return step
