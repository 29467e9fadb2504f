from repro_torch.configs.base import (  # noqa: F401
    AveragingConfig, MLAConfig, MambaConfig, ModelConfig, MoEConfig,
    RunConfig, get_config, reduced, register,
)
