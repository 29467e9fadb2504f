"""Strategy-agnostic training engine (port of ``repro/runtime/engine.py``).

``TrainerEngine`` owns the training state (replica-stacked parameters W,
optimizer state, history) and the iteration loop; everything
method-specific lives in the ``CommunicationStrategy`` and everything
device-specific in the ``ExecutionBackend``.  Per iteration the engine asks
the strategy which programs to run (``strategy.actions(k)``), runs them and
routes their outputs:

* ``info["loss"]``       -> training-loss sample
* ``info["s_k"]``        -> a sync happened: feed ``strategy.observe`` and
                            record the probe / period trajectory
* ``info["s_k_at"]``     -> ``(step, s_k)``: a sync whose probe was fetched
                            later than it was measured (DaSGD's overlapped
                            snapshot), recorded against its snapshot step
* ``info["inner_sync"]`` -> hierarchical inner-sync marker

On a backend whose replicas are spread over processes (the mesh backend)
every process runs this loop over its own replicas: W is its chunk, and
``backend.local_replicas`` cuts each batch to the chunk's rows.  The
history's scalars (loss, S_k, periods) are global, so every process keeps
the same history; the checkpoint callback gathers the chunks
(``backend.gather_replicas``) and the writer process alone writes them.

A telemetry clock (``runtime/clock.py``) rides the backend, which wraps
every program it lowers, and its Timeline rides the engine
(``engine.timeline``; ``TrainHistory.timing``).  The engine's phase
recorder (``runtime/phases.py``, ``engine.phases``) reaches the programs
through the backend too; the loop marks its own phases in it (``data``:
the batch; ``keys``: the PRNG folds; ``readback``: the loss and S_k read
to the host; ``observe``: the strategy's schedule and the callbacks).  It
records under a clock that times programs on the device (``WallClock``,
whose Timeline then sums the phases under ``by_phase``) and inside a
``torch.profiler`` session.  A small callback bus hangs
off the loop (variance probing, periodic eval, checkpoints); a run resumes
from a checkpoint through ``TrainerEngine.load_state``
(``checkpoint/io.py``).
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
from repro_torch.core import prng
from repro_torch.device import DeviceLike
from repro_torch.runtime.clock import Clock, Timeline
from repro_torch.runtime.phases import PhaseRecorder
from repro_torch.strategies import CommunicationStrategy, make_strategy
from repro_torch.tree import tree_leaves, tree_unflatten

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
    inner_sync_steps: List[int] = field(default_factory=list)  # hierarchical
    lrs: List[float] = field(default_factory=list)
    lr_start_step: int = 0
    evals: List[Dict[str, float]] = field(default_factory=list)
    eval_steps: List[int] = field(default_factory=list)
    wall_s: float = 0.0
    n_syncs: int = 0
    # Timeline.summary() plus the clock's kind and now() when the engine
    # carried a clock; None on unclocked runs
    timing: Optional[Dict[str, Any]] = None
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
        """On clocked runs ``metrics["timing"]`` is the step program's
        ``ProgramTiming``."""
        pass

    def on_sync(self, engine: "TrainerEngine", k: int, s_k: float,
                timing=None) -> None:
        """``timing`` is the exchange's ``ProgramTiming`` on clocked runs,
        None otherwise."""
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
                float(engine.backend.parameter_variance(engine.W)))
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
            ev = evaluate(self.loss_fn, engine.W, self.batches_fn(),
                          backend=engine.backend)
            engine.history.evals.append(ev)
            engine.history.eval_steps.append(k)


class Checkpointer(Callback):
    """Save (W, opt_state, strategy state, clock state) every ``every``
    steps, so a restored run continues the identical sync schedule.

    ``keep_replicas=False`` collapses W to the replica mean and drops the
    optimizer state: an export checkpoint for serving or eval, which
    ``TrainerEngine.load_state`` refuses (it needs the replica axis)."""

    def __init__(self, path: str, every: int, keep_replicas: bool = True):
        self.path = path
        self.every = max(1, every)
        self.keep_replicas = keep_replicas

    def on_iteration_end(self, engine, k, metrics):
        # after any sync of iteration k: the saved W must match the saved
        # (post-observe) strategy state
        if (k + 1) % self.every == 0:
            self.save(engine, k + 1)

    def save(self, engine: "TrainerEngine", step: int) -> None:
        """Every process calls this (the gathers are collectives); the
        backend's writer writes."""
        from repro_torch.checkpoint.io import save_checkpoint, strategy_state
        backend = engine.backend
        if self.keep_replicas:
            W = backend.gather_replicas(engine.W)
            opt = backend.gather_replicas(engine.opt_state)
        else:
            W, opt = backend.collapse(engine.W), None
        state = strategy_state(engine.strategy)
        if backend.is_writer:
            save_checkpoint(self.path, W, opt_state=opt, step=step,
                            controller_state=state,
                            clock_state=(engine.clock.state_dict()
                                         if engine.clock else None))
        backend.barrier()


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
                 clock: Optional[Clock] = None,
                 callbacks: Sequence[Callback] = (),
                 track_variance_every: int = 0,
                 seed: int = 0,
                 device: DeviceLike = None):
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
        self.clock = clock
        self.timeline: Optional[Timeline] = clock.timeline if clock else None
        # unconditional: None also clears a clock that an earlier engine
        # left bound on a reused backend
        self.backend.set_clock(clock)
        self.phases = PhaseRecorder(cuda=self.backend.device.type == "cuda")
        self.phases.on = bool(getattr(clock, "times_device", False))
        if self.phases.on:
            self.timeline.phases = self.phases
        self.backend.set_phases(self.phases)
        self.strategy = strategy
        self.strategy.compile(loss_fn, optimizer, backend=self.backend)
        self.strategy.bind_clock(clock)
        self._optimizer = optimizer
        self._n_replicas = n_replicas
        self.loss_fn = loss_fn
        self.data_fn = data_fn
        self.lr_fn = lr_fn
        self.total_steps = total_steps
        self.callbacks: List[Callback] = list(callbacks)
        if track_variance_every:
            self.callbacks.append(VarianceProbe(track_variance_every))
        # the reference's key stream: fold (k, j) into PRNGKey(seed + 17)
        self._base_key = prng.prng_key(seed + 17)
        self._comm_event_base = 0      # restored events count elsewhere
        self.history = TrainHistory(method=self.strategy.name)
        self.W: Optional[Pytree] = None
        self.opt_state: Optional[Pytree] = None
        if params0 is not None:
            self.W = self.backend.stack_params(params0)
            self.opt_state = self.backend.init_opt_state(optimizer, self.W)

    def load_state(self, W: Pytree, opt_state: Optional[Pytree] = None,
                   strategy_state: Optional[Dict] = None,
                   clock_state: Optional[Dict] = None) -> None:
        """Install checkpointed state (replica-stacked W) for resume; the
        leaves may be tensors on any device or host arrays (a checkpoint
        of either package).  Export checkpoints
        (``Checkpointer(keep_replicas=False)``) lack the replica axis and
        are refused.  The state is copied into fresh buffers on the
        backend's device, since the programs write it in place: a tree
        loaded onto the host (``load_checkpoint(path, "cpu")``) is copied
        onto the card once, while one loaded onto the card is held there
        twice until the caller drops it; with
        params0 the leaves take the engine's own tree (a checkpoint keeps
        no empty dict, such as OLMo's parameterless norms).
        ``opt_state=None`` keeps the engine's fresh optimizer state: the
        schedule still resumes exactly, but momentum and adamw restart
        from zero, so the losses are not bit-identical."""
        got = [tuple(x.shape) for x in tree_leaves(W)]
        if self.W is not None:
            want = [(self._n_replicas,) + s[1:]
                    for s in self.backend.whole_shapes(self.W)]
        else:
            # no params0: every leaf must still lead with the replica axis
            # this engine was built for
            want = [(self._n_replicas,) + s[1:] for s in got]
        if want != got:
            raise ValueError(
                "checkpoint does not match the engine's replica-stacked "
                "state (was it saved with keep_replicas=False? such "
                f"checkpoints are export-only): {got[:1]} vs {want[:1]}")
        if self.W is not None:
            W = tree_unflatten(self.W, tree_leaves(W))
        W = self.backend.local_replicas(W)
        self.W = None                  # free the old buffers first
        self.W = self.backend.put_params(self.backend.own(W))
        if opt_state is not None:
            opt_state = self.backend.local_replicas(opt_state)
            if self.opt_state is not None:
                shapes = [[tuple(x.shape) for x in tree_leaves(opt_state)],
                          self.backend.whole_shapes(self.opt_state)]
                if shapes[0] != shapes[1]:
                    raise ValueError("checkpoint's optimizer state does not "
                                     "match the engine's optimizer")
                opt_state = tree_unflatten(self.opt_state,
                                           tree_leaves(opt_state))
            self.opt_state = None
            self.opt_state = self.backend.put_opt(
                self.backend.own(opt_state), self.W)
        elif self.opt_state is None:
            # no optimizer state anywhere: a fresh one (docstring caveat)
            self.opt_state = self.backend.init_opt_state(
                self._optimizer, self.W)
        # the clock before the strategy: a restored time-driven controller
        # keeps its block start in clock coordinates
        if clock_state is not None and self.clock is not None:
            self.clock.load_state_dict(clock_state)
        if strategy_state is not None:
            from repro_torch.checkpoint.io import restore_strategy
            restore_strategy(self.strategy, strategy_state)
        # n_syncs counts per history: syncs before the restore belong to
        # the saved run's
        self._comm_event_base = self.strategy.n_comm_events

    def run(self, start_step: int = 0,
            num_steps: Optional[int] = None) -> TrainHistory:
        """Run iterations [start_step, start_step + num_steps); call again
        with the next ``start_step`` to continue, or to resume after
        ``load_state``: the strategy's schedule state carries across."""
        if self.W is None:
            raise RuntimeError("no parameters: pass params0 or load_state()")
        stop = self.total_steps if num_steps is None \
            else min(self.total_steps, start_step + num_steps)
        hist = self.history
        if not hist.lrs:
            hist.lr_start_step = start_step
        t0 = time.time()
        tl = self.timeline
        # a sampled WallClock keeps the device queue ahead of the host: a
        # per-step float(loss) would synchronize every step, so losses
        # stay device scalars until the run ends (same values)
        defer_loss = bool(getattr(self.clock, "defer_loss_readback", False))
        phase = self.phases.phase

        def record_sync(at, lr_at, s_val, timing):
            """One sync into history, controller and callbacks, shared by
            the immediate ("s_k") and the overlapped ("s_k_at") paths."""
            with phase("readback"):
                s_k = float(s_val)
            with phase("observe"):
                self.strategy.observe(at, lr_at, s_k)
                hist.s_k.append(s_k)
                hist.sync_steps.append(at)
                hist.period_history.append(self.strategy.period)
                for cb in self.callbacks:
                    cb.on_sync(self, at, s_k, timing)

        for k in range(start_step, stop):
            self.phases.k = k
            lr = self.lr_fn(k)
            hist.lrs.append(lr)
            with phase("data"):
                batch = self.backend.local_replicas(self.data_fn(k))
            with phase("keys"):
                step_key = prng.fold_in(self._base_key, k)
            step_info: Dict[str, Any] = {}
            if tl is not None:
                tl.step = k          # dispatches below stamp this iteration
            with phase("observe"):
                actions = self.strategy.actions(k)
            for j, action in enumerate(actions):
                with phase("keys"):
                    key = prng.fold_in(step_key, j)
                self.W, self.opt_state, info = self.strategy.dispatch(
                    action, self.W, self.opt_state, batch, lr, key)
                timing = tl.last if tl is not None else None
                if "loss" in info:
                    step_info = info
                    with phase("readback"):
                        loss_val = (info["loss"] if defer_loss
                                    else float(info["loss"]))
                    hist.losses.append(loss_val)
                    with phase("observe"):
                        self.strategy.observe_loss(k, loss_val)
                        if timing is not None:
                            info["timing"] = timing
                        for cb in self.callbacks:
                            cb.on_step_end(self, k, info)
                if "s_k" in info:
                    record_sync(k, lr, info["s_k"], timing)
                if "s_k_at" in info:
                    # the probe belongs to the snapshot iteration; at most
                    # one exchange is in flight (delay < period), so the
                    # history stays in order
                    at, s_val = info["s_k_at"]
                    at = int(at)
                    if tl is not None:
                        # on_sync gets the exchange's record, written at
                        # dispatch, not the apply program's (tl.last)
                        timing = next(
                            (r for r in reversed(tl.records)
                             if r.overlap and r.step == at), timing)
                    record_sync(at, self.lr_fn(at), s_val, timing)
                if info.get("inner_sync"):
                    hist.inner_sync_steps.append(k)
            with phase("observe"):
                for cb in self.callbacks:
                    cb.on_iteration_end(self, k, step_info)
        if defer_loss:
            hist.losses[:] = [float(v) for v in hist.losses]
        hist.wall_s += time.time() - t0
        hist.n_syncs = self.strategy.n_comm_events - self._comm_event_base
        if tl is not None:
            hist.timing = dict(tl.summary(), clock=self.clock.kind,
                               sim_wall_s=self.clock.now())
        hist.final_W = self.W
        hist.final_opt = self.opt_state
        for cb in self.callbacks:
            cb.on_run_end(self)
        return hist


@torch.no_grad()
def evaluate(loss_fn, W: Pytree, batches,
             backend: Optional[ExecutionBackend] = None) -> Dict[str, float]:
    """Evaluate the replica-averaged model (the mean over every replica
    through ``backend.collapse`` where one is given)."""
    params = avg.replica_mean(W) if backend is None else backend.collapse(W)
    tot: Dict[str, float] = {}
    n = 0
    for b in batches:
        _, aux = loss_fn(params, b)
        for kk, v in aux.items():
            tot[kk] = tot.get(kk, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in tot.items()}
