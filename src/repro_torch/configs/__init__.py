from repro_torch.configs.base import (  # noqa: F401
    AveragingConfig, InputShape, INPUT_SHAPES, MLAConfig, MambaConfig,
    ModelConfig, MoEConfig, ParallelismPlan, RunConfig, available_configs,
    get_config, reduced, register,
)
