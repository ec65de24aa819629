"""The model zoo's train step on one device (counterpart of the
single-device part of `repro/launch/specs.py::make_train_spec`).

`ARCH_OPTIMIZER` picks each arch's optimizer as JAX does (Adafactor for
the >100B configs, whose Adam moments would not fit, AdamW otherwise),
and `make_train_step` is `make_train_spec`'s `train_step` body: value and
gradient of `model.loss_fn` (with its aux), `opt.update`, then
`apply_updates`, the parameters and the optimizer state updated in place.
`LoweredSpec` is the bundle a sharded spec gives
(`train/distributed.py::make_mdgnn_train_spec`); the zoo's sharded specs
and the prefill / decode specs are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.archs.base import Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils.tree import tree_leaves, tree_unflatten

ARCH_OPTIMIZER = {
    "arctic-480b": "adafactor",
    "kimi-k2-1t-a32b": "adafactor",
    "command-r-plus-104b": "adafactor",
}


@dataclasses.dataclass
class LoweredSpec:
    """A step and how its arguments and results lie on a DeviceMesh:
    `args` are meta-device stand-ins (shapes and dtypes, no data),
    `in_shardings` / `out_shardings` trees of DTensor placements (a tuple,
    one per mesh dim) in the arguments' and results' layout; a placements
    tuple where a subtree stands applies to all of its leaves.
    `donate_argnums` names the arguments whose storage the step updates in
    place (JAX donates them; the port's steps write them in place)."""
    fn: Any
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()


def make_optimizer(arch_id: str, lr=1e-4):
    """The arch's optimizer from ARCH_OPTIMIZER at `lr`."""
    return opt_lib.OPTIMIZERS[ARCH_OPTIMIZER.get(arch_id, "adamw")](lr)


def loss_and_grads(model: Model, params, batch):
    """(loss, aux, grads): the loss and its gradient with respect to
    every parameter leaf (zeros where it does not reach, as jax.grad
    gives), in `params`' tree. The parameter leaves are marked as
    requiring grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        tree_unflatten(params, grads)


def make_train_step(model: Model, opt: opt_lib.Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    batch holds "tokens" and "targets" (B, S) and the arch's
    `extra_inputs`. The parameters are updated in place (the JAX step
    donates them) and the returned loss is a detached device scalar, so
    a step needs no host sync."""
    def train_step(params, opt_state, batch):
        loss, _, grads = loss_and_grads(model, params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        opt_lib.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
