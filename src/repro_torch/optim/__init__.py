"""Optimizers (counterpart of `repro/optim`): AdamW with the JAX package's
formula, on dicts of tensors."""
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates

__all__ = ["Optimizer", "adamw", "apply_updates"]
