"""Learning-rate schedules (counterpart of `repro/optim/schedules.py`),
including the paper's Theorem-2 step size. Each returns fn(step) -> a
float32 tensor on the step's device; the optimizers call it with their
device-side step count, so a schedule adds no host sync."""
from __future__ import annotations

import math

import torch


def _step(step):
    return torch.as_tensor(step).float()


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to `peak` over `warmup` steps, then a cosine decay
    to `floor` at `total`."""
    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return fn


def pres_schedule(mu: float, lipschitz: float, n_batches: int):
    """Theorem 2: eta_t = mu / (L * sqrt(K * t)), the convergence-optimal
    step size given memory coherence mu and K temporal batches an epoch."""
    def fn(step):
        t = torch.clamp(_step(step), min=1.0)
        return mu / (lipschitz * torch.sqrt(n_batches * t))

    return fn
