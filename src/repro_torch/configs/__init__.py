from repro_torch.configs.base import (  # noqa: F401
    AveragingConfig, MLAConfig, MambaConfig, ModelConfig, MoEConfig,
    ParallelismPlan, RunConfig, available_configs, get_config, reduced,
    register,
)
