from tpugan_torch.configs.config import (  # noqa: F401
    Config,
    DataConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    get_preset,
    list_presets,
)
