"""The pluggable communication-strategy API (port of
``repro/strategies/base.py``).

A ``CommunicationStrategy`` owns everything policy-specific:

* ``compile(loss_fn, optimizer, backend)`` — build the strategy's programs
  by emitting ``CollectiveOp`` descriptors and asking the
  ``ExecutionBackend`` to lower them.  Programs share one signature
  ``(W, opt_state, batch, lr, key) -> (W, opt_state, info)``.
* ``actions(k)`` — the host-side decision: which programs run at
  iteration k, in order.
* ``observe(k, lr, s_k)`` — feedback after a sync (Algorithm 2 lines 14-19).
* ``sync_op()`` — the descriptor of one communication event, and the sole
  pricing source of the accounting hooks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from repro_torch.backends.ops import CollectiveOp, all_mean_op, replica_step_op
from repro_torch.configs.base import AveragingConfig
from repro_torch.core.comm_model import CommStats, comm_time

Pytree = Any
# program: (W, opt_state, batch, lr, key) -> (W, opt_state, info)
#   info["loss"] -> the engine records a training-loss sample
#   info["s_k"]  -> the program was a sync; the engine feeds observe()
Program = Callable[..., Tuple[Pytree, Optional[Pytree], Dict[str, Any]]]

STEP = "step"
SYNC = "sync"


class CommunicationStrategy:
    """Base class; concrete strategies override the hooks they need."""

    name = "base"

    def __init__(self, cfg: AveragingConfig, total_steps: int):
        self.cfg = cfg
        self.total_steps = total_steps
        self.programs: Dict[str, Program] = {}
        self.backend = None            # set by compile()
        self._comm_events = 0

    def compile(self, loss_fn, optimizer, backend=None,
                avg_cfg: Optional[AveragingConfig] = None) -> None:
        """Build ``self.programs`` against ``backend`` (an instance, a
        registered name, or None for the default vmap backend on the
        card)."""
        if avg_cfg is not None and avg_cfg != self.cfg:
            raise ValueError(
                f"strategy '{self.name}' was constructed with a different "
                "AveragingConfig; rebuild it via make_strategy(avg_cfg, ...)")
        from repro_torch.backends import resolve_backend
        self.backend = resolve_backend(backend)
        self.programs = self._build_programs(loss_fn, optimizer, self.backend)

    def _build_programs(self, loss_fn, optimizer, backend) -> Dict[str, Program]:
        raise NotImplementedError

    def dispatch(self, action: str, W, opt_state, batch, lr, key):
        return self.programs[action](W, opt_state, batch, lr, key)

    def actions(self, k: int) -> Tuple[str, ...]:
        raise NotImplementedError

    def observe(self, k: int, lr: float, s_k: float) -> None:
        """Feedback after the sync program ran at iteration k."""

    def observe_loss(self, k: int, loss: float) -> None:
        """Per-step training loss feedback (loss-adaptive policies)."""

    @property
    def period(self) -> int:
        return 1

    @property
    def n_comm_events(self) -> int:
        return self._comm_events

    def step_op(self) -> CollectiveOp:
        return replica_step_op()

    def sync_op(self) -> CollectiveOp:
        return all_mean_op()

    def comm_bytes_per_sync(self, n_params: int, n_nodes: int) -> float:
        return self.sync_op().wire_bytes(n_params, n_nodes)

    def comm_events_for(self, total_steps: int, n_syncs: int) -> int:
        return n_syncs

    def comm_stats(self, n_params: int, n_nodes: int, total_steps: int,
                   n_syncs: int, bandwidth: float) -> CommStats:
        per = self.comm_bytes_per_sync(n_params, n_nodes)
        ev = self.comm_events_for(total_steps, n_syncs)
        coll = self.sync_op().collective or "all_reduce"
        return CommStats(per, ev, comm_time(per, ev, n_nodes, bandwidth,
                                            collective=coll))


_STRATEGIES: Dict[str, Type[CommunicationStrategy]] = {}


def register_strategy(cls: Type[CommunicationStrategy]):
    """Class decorator: register under ``cls.name``."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"{cls.__name__} needs a unique .name")
    _STRATEGIES[cls.name] = cls
    return cls


def get_strategy_cls(name: str) -> Type[CommunicationStrategy]:
    if name not in _STRATEGIES:
        raise KeyError(
            f"unknown strategy '{name}'; available: {available_strategies()}")
    return _STRATEGIES[name]


def make_strategy(cfg: AveragingConfig, total_steps: int,
                  name: Optional[str] = None, **kw) -> CommunicationStrategy:
    return get_strategy_cls(name or cfg.method)(cfg, total_steps, **kw)


def available_strategies() -> List[str]:
    return sorted(_STRATEGIES)


def comm_stats_for(name: str, cfg: AveragingConfig, n_params: int,
                   n_nodes: int, total_steps: int, n_syncs: int,
                   bandwidth: float) -> CommStats:
    s = make_strategy(cfg, total_steps, name=name)
    return s.comm_stats(n_params, n_nodes, total_steps, n_syncs, bandwidth)
