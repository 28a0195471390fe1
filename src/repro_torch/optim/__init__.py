from repro_torch.optim.adam import (Adam, AdamState, cosine_schedule,
                                     global_norm)

__all__ = ["Adam", "AdamState", "cosine_schedule", "global_norm"]
