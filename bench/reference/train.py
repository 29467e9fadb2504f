"""The reference's first iterations of a cell's training job, in f32 with
TF32 off: R replicas of the model from the same initial weights, each on
its own rows of every batch; adamw (decoupled weight decay, bias
correction); the strategy's schedule (syncs at every iteration below
``warmup_sync``, then every ``p_init``-th: ADPSGD's sampling phase); a
sync is the replica mean written into every replica, or for
``qsgd_periodic`` after its first sync, QSGD's exchange of each replica's
delta from the anchor (levels from the threefry uniforms), whose mean
moves the anchor.  At each sync, S_k = (1/R)·Σ_i ||w̄ − w_i||² summed
over the leaves, before the mean is written back (of the dequantized
deltas, for the quantized exchange).  Returns what the comparison reads:
each iteration's loss (the replicas' mean), S_k at each sync, each
replica's first gradient by leaf and each replica's change by leaf after
the iterations followed."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from bench.reference import threefry
from bench.reference.model import Ref


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in the order of sorted dict keys and list positions."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, f"{prefix}/{i}")]
    return [prefix]


def rebuild(tree, flat: Sequence[torch.Tensor]):
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [go(x) for x in t]
        return next(it)
    return go(tree)


def sync_at(traffic: Dict, steps: int) -> List[bool]:
    """Which of the first ``steps`` iterations end in a sync: every one
    below ``warmup_sync``, then every ``p_init``-th (the period holds in
    ADPSGD's sampling phase, which lasts far past these iterations)."""
    out, cnt = [], 0
    for k in range(steps):
        if k < traffic["warmup_sync"]:
            out.append(True)
            continue
        cnt += 1
        out.append(cnt >= traffic["p_init"])
        if out[-1]:
            cnt = 0
    return out


def mean_sqdev(xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, float]:
    """The mean of one leaf's R copies, and (1/R)·Σ_i ||mean − x_i||²."""
    mean = sum(xs) / len(xs)
    return mean, sum(float((x - mean).square().sum()) for x in xs) / len(xs)


def qsgd_exchange(W: List[List[torch.Tensor]], anchor: List[torch.Tensor],
                  key, bits: int) -> float:
    """Every replica's delta from the anchor quantized to levels in
    [-s, s], s = 2^(bits-1) - 1, by stochastic rounding against
    ``uniform(split(fold_in(key, r), L)[leaf])``; the mean of the
    dequantized deltas moves the anchor, which every replica takes.
    Returns S_k of the dequantized deltas."""
    s = (1 << (bits - 1)) - 1
    R, L = len(W), len(anchor)
    keys = [threefry.split(threefry.fold_in(key, r), L) for r in range(R)]
    s_k = 0.0
    for i, a in enumerate(anchor):
        dq = []
        for r in range(R):
            d = W[r][i] - a
            norm = torch.linalg.vector_norm(d)
            u = threefry.uniform(keys[r][i], d.shape, d.device)
            scaled = torch.where(norm > 0, d.abs() / norm * s,
                                 torch.zeros_like(d))
            low = scaled.floor()
            level = (torch.sign(d) * (low + (u < scaled - low).float())
                     ).clamp(-128, 127)
            dq.append(level * (norm / s))
            del d, u, scaled, low, level
        mean, sq = mean_sqdev(dq)
        s_k += sq
        a += mean
        for r in range(R):
            W[r][i].copy_(a)
        del dq
    return s_k


def follow(cfg: Dict, traffic: Dict, params0, params_host, tokens,
           engine_seed: int, precision: str = "f32",
           steps: int = 3) -> Dict[str, list]:
    """``params0`` gives the tree's structure, ``params_host`` its leaves
    (on any device); ``tokens`` (n, R, b, S) the batches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cfg["training"]
    b1, b2, eps, wd = (tr["adam_b1"], tr["adam_b2"], tr["adam_eps"],
                       tr["weight_decay"])
    ref = Ref(cfg, precision)
    R = traffic["replicas"]
    device = tokens.device
    W0 = [x.to(device, torch.float32) for x in params_host]
    W = [[x.clone() for x in W0] for _ in range(R)]
    m = [[torch.zeros_like(x) for x in W[0]] for _ in range(R)]
    v = [[torch.zeros_like(x) for x in W[0]] for _ in range(R)]
    anchor = None
    base = threefry.key(engine_seed + 17)
    losses, grad_norms, s_ks = [], [], []
    for k, sync in enumerate(sync_at(traffic, steps)):
        lr = traffic["lr"]
        t = k + 1
        step_losses = []
        for r in range(R):
            live = [x.detach().requires_grad_(True) for x in W[r]]
            loss = ref.loss(rebuild(params0, live),
                            tokens[k % tokens.shape[0], r])
            grads = torch.autograd.grad(loss, live)
            step_losses.append(float(loss.detach()))
            if k == 0:
                grad_norms.append([float(torch.linalg.vector_norm(g))
                                   for g in grads])
            with torch.no_grad():
                for p, mm, vv, g in zip(W[r], m[r], v[r], grads):
                    mm.mul_(b1).add_((1 - b1) * g)
                    vv.mul_(b2).add_((1 - b2) * g.square())
                    upd = (mm / (1 - b1 ** t)) / ((vv / (1 - b2 ** t)).sqrt()
                                                  + eps)
                    p.sub_(lr * (upd + wd * p))
            del live, grads, loss
        losses.append(sum(step_losses) / R)
        if not sync:
            continue
        with torch.no_grad():
            if traffic["method"] == "qsgd_periodic" and anchor is not None:
                key = threefry.fold_in(threefry.fold_in(base, k), 1)
                s_ks.append(qsgd_exchange(W, anchor, key,
                                          traffic["qsgd_bits"]))
                continue
            s_k = 0.0
            for i in range(len(W[0])):
                mean, sq = mean_sqdev([W[r][i] for r in range(R)])
                s_k += sq
                for r in range(R):
                    W[r][i].copy_(mean)
            s_ks.append(s_k)
            if traffic["method"] == "qsgd_periodic":
                anchor = [x.clone() for x in W[0]]
    deltas = []
    with torch.no_grad():
        for r in range(R):
            deltas.append([float(torch.linalg.vector_norm(x - x0))
                           for x, x0 in zip(W[r], W0)])
    return {"losses": losses, "s_k": s_ks, "grad_norms": grad_norms,
            "delta_norms": deltas}
