"""Optimizers and schedules (counterpart of `repro/optim`): AdamW,
Adafactor and SGD with the JAX package's formulas, on dicts of tensors."""
from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adafactor,
                                          adamw, apply_updates,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import cosine_schedule, pres_schedule

__all__ = ["OPTIMIZERS", "Optimizer", "adafactor", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_schedule", "pres_schedule", "sgd"]
