from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWState, clip_by_global_norm, global_norm

__all__ = ["adamw", "schedule", "AdamWState", "clip_by_global_norm",
           "global_norm"]
