"""Pluggable communication strategies (see base.py for the API).

Importing this package registers the ported strategies: fullsgd / cpsgd /
adpsgd / decreasing.  QSGD, hierarchical, AdaComm and DaSGD come in later
parts of the port.
"""
from repro_torch.strategies.base import (  # noqa: F401
    CommunicationStrategy, available_strategies, comm_stats_for,
    get_strategy_cls, make_strategy, register_strategy,
)
from repro_torch.strategies.periodic import (  # noqa: F401
    AdaptivePeriodStrategy, ConstantPeriodStrategy, DecreasingPeriodStrategy,
    FullSGDStrategy, PeriodicAveragingStrategy,
)
