from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, get_optimizer, momentum, sgd,
)
from repro_torch.optim.schedules import make_lr_schedule  # noqa: F401
