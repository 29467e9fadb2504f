"""Optimizers as functional updates over parameter trees (port of
``repro/optim/optimizers.py``; ``torch.optim`` is not used because its
momentum dampening and decoupled-decay forms differ from the reference).

    state           = opt.init(params, n_replicas=R)
    params, state   = opt.update(grads, state, params, lr)

``init`` on a replica-stacked tree gives stacked state (adamw's step count
``t`` has shape ``(R,)``, one per replica, as ``vmap(init)`` gives in the
reference).  ``update`` works on one replica's views of the stacked
buffers and writes in place — parameters and state are the largest
tensors of a run, and the engine never needs the pre-update values — then
returns the same tensors.  Each update keeps the reference's operation
order, so the two agree to rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[..., Any]
    update: Callable[[Any, Any, Any, float], Tuple[Any, Any]]


def _foreach(fn, *trees):
    for leaves in zip(*(tree_leaves(t) for t in trees)):
        fn(*leaves)


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params, n_replicas: Optional[int] = None):
        return {}

    def update(grads, state, params, lr):
        def upd(p, g):
            g = g + weight_decay * p if weight_decay else g
            p.sub_(lr * g.to(p.dtype))
        _foreach(upd, params, grads)
        return params, state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum — the paper's optimizer (coef 0.9, §IV-A):
    ``m = beta*m + g``, ``p -= lr*m`` (no dampening)."""

    def init(params, n_replicas: Optional[int] = None):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        def upd(p, m, g):
            m.mul_(beta).add_(g + weight_decay * p if weight_decay else g)
            step = beta * m + g if nesterov else m
            p.sub_(lr * step.to(p.dtype))
        _foreach(upd, params, state["m"], grads)
        return params, state

    return Optimizer("momentum", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params, n_replicas: Optional[int] = None):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        shape = () if n_replicas is None else (n_replicas,)
        device = tree_leaves(params)[0].device
        return {"m": z, "v": tree_map(torch.zeros_like, z),
                "t": torch.zeros(shape, dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        t = state["t"]
        t.add_(1)
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf          # bias correction in f32, on the device
        bc2 = 1 - b2 ** tf

        def upd(p, m, v, g):
            gf = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf.square())
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_((lr * (step + weight_decay * p.to(torch.float32)))
                   .to(p.dtype))
        _foreach(upd, params, state["m"], state["v"], grads)
        return params, state

    return Optimizer("adamw", init, update)


def get_optimizer(name: str, *, momentum_coef: float = 0.9,
                  weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(weight_decay)
    if name == "momentum":
        return momentum(momentum_coef, weight_decay)
    if name == "adamw":
        return adamw(weight_decay=weight_decay or 0.1)
    raise ValueError(name)
