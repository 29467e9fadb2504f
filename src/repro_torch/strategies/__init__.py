"""Pluggable communication strategies (see base.py for the API).

Importing this package registers every strategy of the reference:
fullsgd / cpsgd / adpsgd / decreasing / qsgd / hier_adpsgd / qsgd_periodic /
adacomm / dasgd.
"""
from repro_torch.strategies.base import (  # noqa: F401
    CommunicationStrategy, available_strategies, comm_stats_for,
    get_strategy_cls, make_strategy, register_strategy,
)
from repro_torch.strategies.periodic import (  # noqa: F401
    AdaptivePeriodStrategy, ConstantPeriodStrategy, DecreasingPeriodStrategy,
    FullSGDStrategy, PeriodicAveragingStrategy,
)
from repro_torch.strategies.quantized import (  # noqa: F401
    QSGDPeriodicStrategy, QSGDStrategy,
)
from repro_torch.strategies.hierarchical import (  # noqa: F401
    HierarchicalADPSGDStrategy,
)
from repro_torch.strategies.adacomm import AdaCommStrategy  # noqa: F401
from repro_torch.strategies.dasgd import DaSGDStrategy  # noqa: F401
