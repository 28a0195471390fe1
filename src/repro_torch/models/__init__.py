from repro_torch.models.registry import Model, build

__all__ = ["Model", "build"]
