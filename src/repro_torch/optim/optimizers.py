"""AdamW, Adafactor and SGD (counterpart of `repro/optim/optimizers.py`),
on nested dicts of tensors.

Each optimizer is an (init, update) pair:
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)      # in place

The formulas are the JAX package's, not `torch.optim`'s: AdamW with b2 =
0.95, bias-corrected moments and decoupled weight decay -lr * wd * p;
Adafactor with second moments factored over the last two dims of every
leaf of rank >= 2 and each leaf's update clipped to RMS <= 1; SGD with
optional momentum. `lr` is a number or a callable of the step (a device
tensor, counted from 1), as `schedules.py` gives; the step count and
everything computed from it stay on the parameters' device, so an update
needs no host sync. Adafactor is what the >100B MoE configs train with
(`launch/specs.py::ARCH_OPTIMIZER`)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.nn.module import map_axes
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    # param axes tree -> the state's axes tree
    state_axes: Callable | None = None


def apply_updates(params, updates):
    """p += u for every leaf, IN PLACE (the JAX version returns p + u; the
    train step donates its parameters). Returns `params`."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (|grads| + 1e-9)), |grads|):
    the global L2 norm over every leaf, in float32 on the device."""
    with torch.no_grad():
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads), gn


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros32, params),
                "nu": tree_map(_zeros32, params), "step": _step0(params)}

    def update(grads, state, params):
        """(updates, new state); grads and params are not modified."""
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = lr_fn(step)
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                          state["mu"], grads)
            nu = tree_map(
                lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                state["nu"], grads)
            stepf = step.float()
            # fills, not host-scalar copies: a CUDA graph can record them
            bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                           device=stepf.device), stepf)
            bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                           device=stepf.device), stepf)

            def upd(m, v, p):
                u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if weight_decay:
                    u = u - lr_t * weight_decay * p.float()
                return u

            updates = tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    def state_axes(param_axes):
        return {"mu": param_axes, "nu": param_axes, "step": ()}

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; rank >= 2 leaves)
# ---------------------------------------------------------------------------


def adafactor(lr, decay=0.8, eps=1e-30, clip_threshold=1.0) -> Optimizer:
    """A leaf of rank >= 2 keeps row and column statistics over its last
    two dims ("vr": shape[:-1], "vc": shape[:-2] + shape[-1:]); a stacked
    leaf (the scan layout's (L, ...) blocks) is factored and RMS-clipped
    as one leaf, as JAX does."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def mk(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros32(p)}

        return {"m": tree_map(mk, params), "step": _step0(params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = lr_fn(step)
            beta = 1.0 - (step.float() + 1.0) ** (-decay)

            def upd(p, g, m):
                g = g.float()
                g2 = torch.square(g) + eps
                if p.dim() >= 2:
                    vr = beta * m["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                    vc = beta * m["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                    denom = (vr[..., None] / torch.mean(
                        vr, dim=-1, keepdim=True)[..., None]) * vc[..., None, :]
                    u = g * torch.rsqrt(denom + eps)
                    new = {"vr": vr, "vc": vc}
                else:
                    v = beta * m["v"] + (1 - beta) * g2
                    u = g * torch.rsqrt(v + eps)
                    new = {"v": v}
                # update clipping (RMS <= clip_threshold)
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                return -lr_t * u, new

            # the walk follows params, so each leaf's {"vr", "vc"} / {"v"}
            # state arrives whole
            pairs = tree_map(upd, params, grads, state["m"])
            updates = tree_map(lambda t: t[0], pairs)
            new_m = tree_map(lambda t: t[1], pairs)
        return updates, {"m": new_m, "step": step}

    def state_axes(param_axes):
        def mk(ax):
            if len(ax) >= 2:
                return {"vr": tuple(ax[:-1]),
                        "vc": tuple(ax[:-2]) + tuple(ax[-1:])}
            return {"v": tuple(ax)}

        return {"m": map_axes(mk, param_axes), "step": ()}

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum:
            return {"mu": tree_map(_zeros32, params), "step": _step0(params)}
        return {"step": _step0(params)}

    def update(grads, state, params):
        del params
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = lr_fn(step)
            if momentum:
                mu = tree_map(lambda m, g: momentum * m + g.float(),
                              state["mu"], grads)
                return (tree_map(lambda m: -lr_t * m, mu),
                        {"mu": mu, "step": step})
            return (tree_map(lambda g: -lr_t * g.float(), grads),
                    {"step": step})

    def state_axes(param_axes):
        if momentum:
            return {"mu": param_axes, "step": ()}
        return {"step": ()}

    return Optimizer(init, update, state_axes)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}
