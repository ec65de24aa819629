"""AdamW (counterpart of `repro/optim/optimizers.py::adamw` and
`apply_updates`), on nested dicts of tensors.

The formula is the JAX package's, not `torch.optim.AdamW`'s defaults:
b2 = 0.95, bias-corrected moments, decoupled weight decay as
-lr * wd * p, and state {"mu", "nu", "step"}. The step count and the
bias corrections stay on the parameters' device, so an update needs no
host sync."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def apply_updates(params, updates):
    """p += u for every leaf, IN PLACE (the JAX version returns p + u; the
    train step donates its parameters). Returns `params`."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        leaf = tree_leaves(params)[0]
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}

    def update(grads, state, params):
        """(updates, new state); grads and params are not modified."""
        with torch.no_grad():
            step = state["step"] + 1
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
            stepf = step.float()
            bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                             device=stepf.device), stepf)
            bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                             device=stepf.device), stepf)

            def upd(m, v, p):
                u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if weight_decay:
                    u = u - lr * weight_decay * p.float()
                return u

            updates = tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)

