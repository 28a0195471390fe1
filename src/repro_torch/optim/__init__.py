from repro_torch.optim.adam import Adam, AdamState, global_norm

__all__ = ["Adam", "AdamState", "global_norm"]
