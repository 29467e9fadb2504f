"""QSGD baseline (Alistarh et al. 2017) — stochastic quantization (port of
``repro/core/qsgd.py``).

The paper compares ADPSGD against 8-bit QSGD (§IV).  Every iteration each
replica quantizes its gradient, "transmits" it (a quantize → dequantize
round trip on one device) and all replicas apply the mean of the
dequantized gradients, so their trajectories stay identical.

The uniforms of the stochastic rounding come from ``core/prng.py``, the
reference's threefry stream, under the same keys: one split of a
replica's key per leaf, in ``tree_leaves`` order.  With ``use_kernel``
(the default) the norm, the quantization and the dequantization go
through the kernel wrappers (``kernels/ops.py``), which launch the CUDA
kernels for tensors on the card and take the plain versions for tensors
on the CPU; ``use_kernel=False`` takes the plain versions everywhere.
Where many tensors are quantized together (the leaves of a replica's
gradient here, the replicas' deltas of a leaf in the quantized sync) the
caller takes all their norms in one call (``norms``) and hands each to
``quantize``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.averaging import (_mean_metrics, n_replicas,
                                        replica_view, value_and_grad)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.optim.optimizers import Optimizer
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
    u = prng.uniform(key, v.shape, device=v.device)
    if not use_kernel:
        return kref.quantize_ref(vf, u, bits, norm=norm)
    if norm is None:
        norm = torch.sqrt(kops.qsgd_sqnorm(vf))
    return kops.qsgd_quantize(vf, u, norm, bits), norm


def dequantize(levels: torch.Tensor, norm: torch.Tensor, bits: int = 8,
               dtype=torch.float32, *, use_kernel: bool = True
               ) -> torch.Tensor:
    if use_kernel:
        out = kops.qsgd_dequantize(levels, norm, bits)
    else:
        out = kref.dequantize_ref(levels, norm, bits)
    return out.to(dtype)


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
                   use_kernel: bool = True):
    """Full-communication step with quantized gradients:
    step(W, opt_state, batch, lr, key) -> (W, opt_state, metrics).

    Loops over the replicas as ``make_full_step`` does: each replica's
    gradients are quantized and dequantized leaf by leaf under
    ``split(fold_in(key, r), n_leaves)`` and summed in f32 (one
    gradient-sized buffer beside one replica's gradients); the mean,
    cast to each parameter's dtype, updates every replica alike.  With
    ``use_kernel`` the norms of a replica's leaves are taken in one call
    before its quantize loop."""

    def step(W, opt_state, batch, lr, key):
        R = n_replicas(W)
        g_sum: List[torch.Tensor] = []
        losses, auxs = [], []
        for r, rkey in enumerate(replica_keys(key, range(R))):
            loss, aux, grads = value_and_grad(
                loss_fn, replica_view(W, r), replica_view(batch, r))
            leaves = tree_leaves(grads)
            del grads
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
                    if r == 0:
                        g_sum.append(dq)
                    else:
                        g_sum[i].add_(dq)
            losses.append(loss)
            auxs.append(aux)
        params0 = tree_leaves(replica_view(W, 0))
        g_mean = tree_unflatten(
            replica_view(W, 0),
            [(g / R).to(p.dtype) for g, p in zip(g_sum, params0)])
        del g_sum
        with torch.no_grad():
            for r in range(R):
                optimizer.update(g_mean, replica_view(opt_state, r),
                                 replica_view(W, r), lr)
        metrics = {"loss": torch.stack(losses).mean(),
                   **(_mean_metrics(auxs) if auxs[0] else {})}
        return W, opt_state, metrics

    return step
