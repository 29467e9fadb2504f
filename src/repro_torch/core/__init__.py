from repro_torch.core.averaging import (  # noqa: F401
    make_full_step, make_local_step, n_replicas, parameter_variance,
    replica_mean, stack_replicas, sync_opt_state, sync_replicas,
)
from repro_torch.core.controller import (  # noqa: F401
    ADPSGDController, ConstantPeriodController, DecreasingPeriodController,
    FullSyncController, PeriodController,
)
