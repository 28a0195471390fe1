from repro_torch.configs.base import (ALIASES, ARCH_IDS, INPUT_SHAPES,
                                      InputShape, ModelConfig, MoEConfig,
                                      SSMConfig, VisionStubConfig,
                                      get_config)

__all__ = [
    "ALIASES", "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "MoEConfig", "SSMConfig", "VisionStubConfig", "get_config",
]
