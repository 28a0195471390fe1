from repro_torch.checkpoint.io import (latest_step, load_pytree, restore,
                                       save_pytree)

__all__ = ["latest_step", "load_pytree", "restore", "save_pytree"]
