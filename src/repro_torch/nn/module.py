"""Parameter construction for the model zoo (counterpart of the
`ParamBuilder` / `stack_params` part of `repro/nn/module.py`).

Parameters are nested dicts of tensors with the JAX package's names and
shapes. The JAX builder also keeps a tree of logical sharding axes; the
port keeps none (the sharding rules and helpers are ROADMAP Queue 1
item 21's). Draws come from one `torch.Generator` on the
target device, so they differ from `jax.random`'s: tests carry JAX's
parameters over with `bridge.zoo_params_from_numpy`."""
from __future__ import annotations

import math
from typing import Sequence

import torch


class ParamBuilder:
    """Accumulates a parameter tree under hierarchical names; every child
    draws from the same generator, on the generator's device."""

    def __init__(self, gen: torch.Generator, dtype=torch.float32):
        self.gen = gen
        self.dtype = dtype
        self.params: dict = {}

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def sub(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.gen, self.dtype)
        self.params[name] = child.params
        return child

    def add(self, name: str, shape: Sequence[int], init: str = "normal",
            scale: float | None = None, dtype=None) -> None:
        """zeros, ones, "normal" (std 1/sqrt(fan-in), fan-in the product of
        all dims but the last, or the one dim of a vector) or "embed"
        (std 1), scaled by `scale` where given, as `repro/nn/module.py`."""
        dtype = dtype or self.dtype
        shape = tuple(shape)
        if init == "zeros":
            value = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=dtype, device=self.device)
        elif init in ("normal", "embed"):
            if init == "normal":
                fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
                std = scale if scale is not None else 1.0 / math.sqrt(
                    max(fan_in, 1))
            else:
                std = scale if scale is not None else 1.0
            # scaled in place: one float32 copy of the leaf at a time
            # (kimi-k2's (384, 7168, 2048) experts are 22.5 GB so)
            value = torch.randn(shape, generator=self.gen,
                                device=self.device).mul_(std).to(dtype)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.params[name] = value


def stack_params(trees: Sequence[dict]) -> dict:
    """Stack per-unit trees (parameters, or decode states whose leaves
    may be tuples of tensors) on a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(stack_params([t[m] for t in trees])
                     for m in range(len(first)))
    return torch.stack(list(trees), 0)


def unstack(tree, i: int):
    """Unit `i` of a stacked tree (views; tuples of leaves stay tuples)."""
    if isinstance(tree, dict):
        return {k: unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(unstack(v, i) for v in tree)
    return tree[i]
