"""QSGD baseline (Alistarh et al. 2017) — stochastic quantization (port of
``repro/core/qsgd.py``).

The paper compares ADPSGD against 8-bit QSGD (§IV).  Every iteration each
replica quantizes its gradient, "transmits" it (a quantize → dequantize
round trip on one device) and all replicas apply the mean of the
dequantized gradients, so their trajectories stay identical.

The uniforms of the stochastic rounding are the reference's threefry
stream (``core/prng.py``) under the same keys: one split of a replica's
key per leaf, in ``tree_leaves`` order.  With ``use_kernel`` (the
default) the norm, the quantization and the dequantization go through
the kernel wrappers (``kernels/ops.py``), which launch the CUDA kernels
for tensors on the card and take the plain versions for tensors on the
CPU; the quantize kernel takes the leaf's key and draws the uniforms
itself (``quantize_keyed``), the same bits ``prng.uniform`` draws for the
plain versions.  ``use_kernel=False`` takes the plain versions
everywhere.
Where many tensors are quantized together (the leaves of a replica's
gradient here, the replicas' deltas of a leaf in the quantized sync) the
caller takes all their norms in one call (``norms``) and hands each to
``quantize``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.averaging import (Exchange, _mean_metrics, n_replicas,
                                        replica_view, value_and_grad)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import phases
from repro_torch.tree import tree_leaves, tree_unflatten

Pytree = Any
replica_keys = prng.replica_keys


def norms(vs: List[torch.Tensor]) -> torch.Tensor:
    """||v||₂ of each tensor of ``vs`` as one f32 tensor (len(vs),): one
    grouped sqnorm launch on the card; each equals the norm ``quantize``
    would take of that tensor alone, bit for bit."""
    return torch.sqrt(kops.qsgd_sqnorm_many(
        [v.to(torch.float32).contiguous() for v in vs]))


def quantize(v: torch.Tensor, key: prng.Key, bits: int = 8, *,
             use_kernel: bool = True, norm: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QSGD stochastic quantization of one tensor:
    q_i = ||v||₂ · sgn(v_i) · ξ_i / s with s = 2^(bits−1) − 1 and
    ξ_i ∈ {⌊|v_i|·s/‖v‖⌋, ⌈…⌉} chosen with uniforms drawn under ``key``,
    so E[q] = v.  ``norm``: ||v||₂ (one f32 value), when the caller has
    taken it already (``norms``).  Returns (int8 levels, f32 norm)."""
    vf = v.to(torch.float32).contiguous()
    if not use_kernel:
        return kref.quantize_ref(
            vf, prng.uniform(key, v.shape, device=v.device), bits, norm=norm)
    if norm is None:
        norm = torch.sqrt(kops.qsgd_sqnorm(vf))
    return kops.qsgd_quantize_keyed(vf, key, norm, bits), norm


def dequantize(levels: torch.Tensor, norm: torch.Tensor, bits: int = 8,
               dtype=torch.float32, *, use_kernel: bool = True
               ) -> torch.Tensor:
    if use_kernel:
        out = kops.qsgd_dequantize(levels, norm, bits)
    else:
        out = kref.dequantize_ref(levels, norm, bits)
    return out.to(dtype)


def delta_keys(key: prng.Key, replica_ids: Sequence[int], n_leaves: int
               ) -> List[List[prng.Key]]:
    """The quantized sync's keys: ``split(fold_in(key, r), n_leaves)`` for
    each global replica index r of ``replica_ids``."""
    return [prng.split(k, n_leaves) for k in replica_keys(key, replica_ids)]


def quantize_deltas(w: torch.Tensor, anchor: torch.Tensor, keys, leaf: int,
                    bits: int = 8, *, use_kernel: bool = True):
    """The quantized sync's sender side for one leaf: the f32 deltas
    ``w_j − anchor`` of the stacked replicas of ``w`` are formed together
    and their norms taken in one call (with the kernel), then each is
    quantized under ``keys[j][leaf]``.  Yields (j, int8 levels, f32 norm)
    replica by replica, each delta dropped once quantized."""
    deltas = [w[j].to(torch.float32) - anchor for j in range(len(w))]
    nms = norms(deltas) if use_kernel else [None] * len(w)
    for j in range(len(w)):
        lv, nm = quantize(deltas[j], keys[j][leaf], bits,
                          use_kernel=use_kernel, norm=nms[j])
        deltas[j] = None
        yield j, lv, nm


@torch.no_grad()
def apply_deltas(w: torch.Tensor, anchor: torch.Tensor, dq: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """The quantized sync's receiver side for one leaf: the replica mean of
    the R dequantized deltas ``dq`` (R, ...) f32 and Σ_r ||dq_r − mean||²
    in one pass (the fused mean + sqdev kernel, or its plain version); the
    anchor moves by the mean, in place, and is written into every replica
    of ``w``.  Returns the sum of squares."""
    if use_kernel:
        mean_d, sq = kops.param_mean_and_sqdev(dq)
    else:
        mean_d, sq = kref.mean_and_sqdev_ref(dq)
    anchor.add_(mean_d)
    w.copy_(anchor.unsqueeze(0).expand_as(w))
    return sq


def quantize_pytree(grads: Pytree, key: prng.Key, bits: int = 8, *,
                    use_kernel: bool = True) -> Pytree:
    """Quantize → dequantize round trip of every leaf (dtype kept)."""
    levels, norms = quantize_split_pytree(grads, key, bits,
                                          use_kernel=use_kernel)
    out = [dequantize(lv, nm, bits, g.dtype, use_kernel=use_kernel)
           for lv, nm, g in zip(tree_leaves(levels), tree_leaves(norms),
                                tree_leaves(grads))]
    return tree_unflatten(grads, out)


def quantize_split_pytree(grads: Pytree, key: prng.Key, bits: int = 8, *,
                          use_kernel: bool = True) -> Tuple[Pytree, Pytree]:
    """The byte-true wire representation: (int8 levels tree, f32 norms
    tree), under the same key stream as ``quantize_pytree``, so
    split + ``dequantize_split_pytree`` equals the fused round trip."""
    leaves = tree_leaves(grads)
    lvs, nms = [], []
    for k, g in zip(prng.split(key, len(leaves)), leaves):
        lv, nm = quantize(g, k, bits, use_kernel=use_kernel)
        lvs.append(lv)
        nms.append(nm)
    return tree_unflatten(grads, lvs), tree_unflatten(grads, nms)


def dequantize_split_pytree(levels: Pytree, norms: Pytree, bits: int = 8,
                            dtype=torch.float32, *,
                            use_kernel: bool = True) -> Pytree:
    """Receiver side of the byte-true exchange."""
    out = [dequantize(lv, nm, bits, dtype, use_kernel=use_kernel)
           for lv, nm in zip(tree_leaves(levels), tree_leaves(norms))]
    return tree_unflatten(levels, out)


def make_qsgd_step(loss_fn, optimizer: Optimizer, bits: int = 8, *,
                   use_kernel: bool = True,
                   replica_ids: Optional[Sequence[int]] = None,
                   exchange: Optional[Exchange] = None, tp=None):
    """Full-communication step with quantized gradients:
    step(W, opt_state, batch, lr, key) -> (W, opt_state, metrics).

    Loops over the replicas as ``make_full_step`` does: each replica's
    gradients are quantized and dequantized leaf by leaf under
    ``split(fold_in(key, r), n_leaves)`` and summed in f32 (one
    gradient-sized buffer beside one replica's gradients); the mean,
    cast to each parameter's dtype, updates every replica alike.  With
    ``use_kernel`` the norms of a replica's leaves are taken in one call
    before its quantize loop.  On the mesh backend W holds this process's
    replicas, ``replica_ids`` their global indices (the keys' stream) and
    ``exchange`` sums the dequantized gradients over the processes.  With
    ``tp`` (the ``replica_tp`` placement) a replica's gradient shards are
    made whole over the model group before they are quantized, so each
    leaf's norm and uniforms are the whole leaf's, and each rank keeps
    its shard of the dequantized gradient."""

    def step(W, opt_state, batch, lr, key):
        R = n_replicas(W)
        if tp is not None:
            tp.bind(W)
        g_sum: List[torch.Tensor] = []
        losses, auxs = [], []
        ids = range(R) if replica_ids is None else replica_ids
        for r, rkey in enumerate(replica_keys(key, ids)):
            loss, aux, grads = value_and_grad(
                loss_fn, replica_view(W, r), replica_view(batch, r), tp)
            leaves = tree_leaves(grads)
            del grads
            if tp is not None:
                leaves = tp.whole(leaves)
            with torch.no_grad():
                nms = (norms(leaves) if use_kernel
                       else [None] * len(leaves))
                for i, k in enumerate(prng.split(rkey, len(leaves))):
                    g = leaves[i]
                    lv, nm = quantize(g, k, bits, use_kernel=use_kernel,
                                      norm=nms[i])
                    leaves[i] = None           # free the gradient leaf
                    dq = dequantize(lv, nm, bits, g.dtype,
                                    use_kernel=use_kernel).to(torch.float32)
                    if tp is not None:
                        dq = tp.cut_leaf(i, dq)
                    if r == 0:
                        g_sum.append(dq)
                    else:
                        g_sum[i].add_(dq)
            losses.append(loss)
            auxs.append(aux)
        metrics = {"loss": torch.stack(losses).mean(),
                   **(_mean_metrics(auxs) if auxs[0] else {})}
        n = R
        if exchange is not None:
            g_sum, metrics, n = exchange(g_sum, metrics)
        params0 = tree_leaves(replica_view(W, 0))
        g_mean = tree_unflatten(
            replica_view(W, 0),
            [(g / n).to(p.dtype) for g, p in zip(g_sum, params0)])
        del g_sum
        with torch.no_grad(), phases.current().phase("optimizer"):
            for r in range(R):
                optimizer.update(g_mean, replica_view(opt_state, r),
                                 replica_view(W, r), lr)
        return W, opt_state, metrics

    return step
