from repro_torch.models.model import (  # noqa: F401
    forward, init_params, lm_loss, param_count,
)
