from repro_torch.data.tokens import (TokenPipeline, TokenPipelineConfig,
                                     device_batch)

__all__ = ["TokenPipeline", "TokenPipelineConfig", "device_batch"]
