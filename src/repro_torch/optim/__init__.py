"""AdamW over latent binarized weights (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     clip_by_global_norm, global_norm, init,
                                     schedule)

__all__ = ["AdamWConfig", "OptState", "apply_updates",
           "clip_by_global_norm", "global_norm", "init", "schedule"]
