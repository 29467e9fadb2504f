"""Strategy-agnostic training engine (port of ``repro/runtime/engine.py``).

``TrainerEngine`` owns the training state (replica-stacked parameters W,
optimizer state, history) and the iteration loop; everything
method-specific lives in the ``CommunicationStrategy`` and everything
device-specific in the ``ExecutionBackend``.  Per iteration the engine asks
the strategy which programs to run (``strategy.actions(k)``), runs them and
routes their outputs:

* ``info["loss"]`` -> training-loss sample
* ``info["s_k"]``  -> a sync happened: feed ``strategy.observe`` and record
                      the probe / period trajectory

A small callback bus hangs off the loop (variance probing, periodic eval).
The telemetry clocks and checkpoints of the reference are not ported yet:
``clock`` must be None.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.backends import ExecutionBackend, resolve_backend
from repro_torch.configs.base import AveragingConfig
from repro_torch.core import averaging as avg
from repro_torch.device import DeviceLike
from repro_torch.strategies import CommunicationStrategy, make_strategy

Pytree = Any


@dataclass
class TrainHistory:
    method: str
    losses: List[float] = field(default_factory=list)
    variances: List[float] = field(default_factory=list)       # Var[W_k] samples
    variance_steps: List[int] = field(default_factory=list)
    s_k: List[float] = field(default_factory=list)             # probe at syncs
    sync_steps: List[int] = field(default_factory=list)
    period_history: List[int] = field(default_factory=list)
    lrs: List[float] = field(default_factory=list)
    lr_start_step: int = 0
    evals: List[Dict[str, float]] = field(default_factory=list)
    eval_steps: List[int] = field(default_factory=list)
    wall_s: float = 0.0
    n_syncs: int = 0
    final_W: Optional[Pytree] = None
    final_opt: Optional[Pytree] = None

    def weighted_avg_variance(self) -> float:
        """Paper Eq. 9: Σ γ_k Var[W_k] / Σ γ_j over the sampled steps."""
        if not self.variances:
            return 0.0
        idx = np.clip(np.array(self.variance_steps) - self.lr_start_step,
                      0, len(self.lrs) - 1)
        g = np.array(self.lrs)[idx]
        return float(np.sum(g * np.array(self.variances)) / np.sum(g))


class Callback:
    """Hook points on the engine loop.  ``on_step_end`` fires after the
    step program but before any sync of the same iteration (pre-sync
    replica drift); ``on_iteration_end`` once all of iteration k's
    programs ran."""

    def on_step_end(self, engine: "TrainerEngine", k: int,
                    metrics: Dict[str, Any]) -> None:
        pass

    def on_sync(self, engine: "TrainerEngine", k: int, s_k: float,
                timing=None) -> None:
        pass

    def on_iteration_end(self, engine: "TrainerEngine", k: int,
                         metrics: Dict[str, Any]) -> None:
        pass

    def on_run_end(self, engine: "TrainerEngine") -> None:
        pass


class VarianceProbe(Callback):
    """Sample Var[W_k] (paper Eq. 7 / Fig 1-2) every ``every`` steps."""

    def __init__(self, every: int):
        self.every = max(1, every)

    def on_step_end(self, engine, k, metrics):
        if k % self.every == 0:
            engine.history.variances.append(
                float(avg.parameter_variance(engine.W)))
            engine.history.variance_steps.append(k)


class PeriodicEval(Callback):
    """Evaluate the replica-averaged model every ``every`` steps."""

    def __init__(self, loss_fn, batches_fn: Callable[[], Iterable],
                 every: int):
        self.loss_fn = loss_fn
        self.batches_fn = batches_fn
        self.every = max(1, every)

    def on_iteration_end(self, engine, k, metrics):
        if (k + 1) % self.every == 0:
            ev = evaluate(self.loss_fn, engine.W, self.batches_fn())
            engine.history.evals.append(ev)
            engine.history.eval_steps.append(k)


class TrainerEngine:
    """Owns state + loop; the strategy owns policy + programs.

    ``device`` places the default backend (the card unless ``"cpu"``);
    an explicit backend instance brings its own device."""

    def __init__(self, *,
                 loss_fn,
                 optimizer,
                 params0: Optional[Pytree] = None,
                 n_replicas: int = 1,
                 data_fn: Callable[[int], Dict[str, torch.Tensor]],
                 lr_fn: Callable[[int], float],
                 total_steps: int,
                 avg_cfg: Optional[AveragingConfig] = None,
                 strategy: Optional[CommunicationStrategy] = None,
                 backend: Optional[ExecutionBackend] = None,
                 clock=None,
                 callbacks: Sequence[Callback] = (),
                 track_variance_every: int = 0,
                 seed: int = 0,
                 device: DeviceLike = None):
        if clock is not None:
            raise NotImplementedError(
                "telemetry clocks (runtime/clock.py) are not ported yet")
        if strategy is None:
            if avg_cfg is None:
                raise ValueError("need avg_cfg or strategy")
            strategy = make_strategy(avg_cfg, total_steps)
        elif avg_cfg is not None and avg_cfg != strategy.cfg:
            raise ValueError(
                "avg_cfg conflicts with the explicit strategy's config; "
                "pass one or the other (or matching configs)")
        self.backend = resolve_backend(backend, device=device)
        self.backend.bind(n_replicas)
        self.strategy = strategy
        self.strategy.compile(loss_fn, optimizer, backend=self.backend)
        self._optimizer = optimizer
        self.loss_fn = loss_fn
        self.data_fn = data_fn
        self.lr_fn = lr_fn
        self.total_steps = total_steps
        self.callbacks: List[Callback] = list(callbacks)
        if track_variance_every:
            self.callbacks.append(VarianceProbe(track_variance_every))
        # the reference folds (k, j) into PRNGKey(seed + 17); the periodic
        # strategies never read the key, so the port passes a stateless int
        self._base_key = seed + 17
        self.history = TrainHistory(method=self.strategy.name)
        self.W: Optional[Pytree] = None
        self.opt_state: Optional[Pytree] = None
        if params0 is not None:
            self.W = avg.stack_replicas(self.backend.put_params(params0),
                                        n_replicas)
            self.opt_state = self.backend.init_opt_state(optimizer, self.W)

    def run(self, start_step: int = 0,
            num_steps: Optional[int] = None) -> TrainHistory:
        """Run iterations [start_step, start_step + num_steps); call again
        with the next ``start_step`` to continue."""
        if self.W is None:
            raise RuntimeError("no parameters: pass params0")
        stop = self.total_steps if num_steps is None \
            else min(self.total_steps, start_step + num_steps)
        hist = self.history
        if not hist.lrs:
            hist.lr_start_step = start_step
        t0 = time.time()
        for k in range(start_step, stop):
            lr = self.lr_fn(k)
            hist.lrs.append(lr)
            batch = self.data_fn(k)
            step_info: Dict[str, Any] = {}
            for j, action in enumerate(self.strategy.actions(k)):
                key = (self._base_key * 1_000_003 + k) * 16 + j
                self.W, self.opt_state, info = self.strategy.dispatch(
                    action, self.W, self.opt_state, batch, lr, key)
                if "loss" in info:
                    step_info = info
                    loss_val = float(info["loss"])
                    hist.losses.append(loss_val)
                    self.strategy.observe_loss(k, loss_val)
                    for cb in self.callbacks:
                        cb.on_step_end(self, k, info)
                if "s_k" in info:
                    s_k = float(info["s_k"])
                    self.strategy.observe(k, lr, s_k)
                    hist.s_k.append(s_k)
                    hist.sync_steps.append(k)
                    hist.period_history.append(self.strategy.period)
                    for cb in self.callbacks:
                        cb.on_sync(self, k, s_k, None)
            for cb in self.callbacks:
                cb.on_iteration_end(self, k, step_info)
        hist.wall_s += time.time() - t0
        hist.n_syncs = self.strategy.n_comm_events
        hist.final_W = self.W
        hist.final_opt = self.opt_state
        for cb in self.callbacks:
            cb.on_run_end(self)
        return hist


@torch.no_grad()
def evaluate(loss_fn, W: Pytree, batches) -> Dict[str, float]:
    """Evaluate the replica-averaged model."""
    params = avg.replica_mean(W)
    tot: Dict[str, float] = {}
    n = 0
    for b in batches:
        _, aux = loss_fn(params, b)
        for kk, v in aux.items():
            tot[kk] = tot.get(kk, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in tot.items()}
