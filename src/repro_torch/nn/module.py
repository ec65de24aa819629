"""Parameter construction and logical-axis sharding rules (counterpart
of `repro/nn/module.py`).

Parameters are nested dicts of tensors with the JAX package's names and
shapes. Draws come from one `torch.Generator` on the target device, so
they differ from `jax.random`'s: tests carry JAX's parameters over with
`bridge.zoo_params_from_numpy`. The builder keeps a tree of logical axes
beside the parameters (one tuple a leaf, one name or None a dim), as
JAX's does; a builder with no generator on the meta device makes
`torch.empty` meta leaves, so a config's shapes and axes come without
memory (kimi-k2's 1 T parameters). The MDGNN's axes are
`models/mdgnn.py::param_axes`.

A tree of logical-axis tuples (one name or None per tensor dim) resolves
through a rule table to mesh-axis names: `logical_to_spec` gives the
port's `PartitionSpec`, with JAX's trimming and collision rules, and
`tree_shardings` the DTensor placements over a `DeviceMesh` (one
`Shard(d)` or `Replicate()` per mesh dim; a multi-axis entry shards one
tensor dim over several mesh dims, in the entry's order)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch


class ParamBuilder:
    """Accumulates (params, axes) trees under hierarchical names; every
    child draws from the same generator, on the generator's device. With
    `gen` None the builder draws nothing: it needs device="meta" and
    makes empty meta leaves."""

    def __init__(self, gen: torch.Generator | None, dtype=torch.float32,
                 device=None):
        if gen is None and torch.device(device or "cpu").type != "meta":
            raise ValueError("a ParamBuilder without a generator builds on "
                             "device='meta' only")
        self.gen = gen
        self.dtype = dtype
        self.device = gen.device if gen is not None else torch.device("meta")
        self.params: dict = {}
        self.axes: dict = {}

    def fresh(self) -> "ParamBuilder":
        """An empty builder drawing from the same generator."""
        return ParamBuilder(self.gen, self.dtype, self.device)

    def sub(self, name: str) -> "ParamBuilder":
        child = self.fresh()
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def add(self, name: str, shape: Sequence[int],
            axes: Sequence[str | None], init: str = "normal",
            scale: float | None = None, dtype=None) -> None:
        """zeros, ones, "normal" (std 1/sqrt(fan-in), fan-in the product of
        all dims but the last, or the one dim of a vector) or "embed"
        (std 1), scaled by `scale` where given, as `repro/nn/module.py`;
        `axes` names the logical axis of each dim."""
        dtype = dtype or self.dtype
        shape = tuple(shape)
        if len(axes) != len(shape):
            raise ValueError(f"{name}: {len(axes)} axes {tuple(axes)} for "
                             f"shape {shape}")
        if init not in ("zeros", "ones", "normal", "embed"):
            raise ValueError(f"unknown init {init!r}")
        if self.gen is None:
            value = torch.empty(shape, dtype=dtype, device="meta")
        elif init == "zeros":
            value = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=dtype, device=self.device)
        else:
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
        self.params[name] = value
        self.axes[name] = tuple(axes)


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


def stack_axes(axes_tree):
    """The axes of a stacked tree: "layers" before every leaf's axes
    (JAX's `stack_params` gives them beside the stacked parameters)."""
    return map_axes(lambda ax: ("layers", *ax), axes_tree)


def unstack(tree, i: int):
    """Unit `i` of a stacked tree (views; tuples of leaves stay tuples)."""
    if isinstance(tree, dict):
        return {k: unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(unstack(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis resolution
# ---------------------------------------------------------------------------

# Values may be a mesh-axis name, a tuple of names, or None (replicated).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "event": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_mlp": None,
    "layers": None,
    "state": None,
    "conv": None,
    "nodes": ("pod", "data"),
    "cache_seq": None,
}

# FSDP: the 'embed' dim of big weights is sharded over the data axis too.
FSDP_RULES = dict(DEFAULT_RULES, embed="data")

# Sequence-parallel decode (batch 1): the KV cache sharded over model.
LONG_CTX_RULES = dict(DEFAULT_RULES, cache_seq="model")

# MDGNN: the memory table and trackers replicated (reads local, writes
# reduced).
MDGNN_REPLICATED_RULES = dict(DEFAULT_RULES, nodes=None)

# MDGNN: every parameter replicated (they are KB-sized) and the model axis
# spent as further event / data parallelism.
MDGNN_EVENT_DP_RULES = dict(
    DEFAULT_RULES,
    embed=None, mlp=None, vocab=None, heads=None, expert=None,
    batch=("pod", "data", "model"),
    event=("pod", "data", "model"),
    nodes=("pod", "data", "model"),
)

# ... and the state tables replicated as well.
MDGNN_EVENT_DP_REPL_RULES = dict(MDGNN_EVENT_DP_RULES, nodes=None)

RULE_SETS: dict[str, dict[str, Any]] = {
    "default": DEFAULT_RULES,
    "fsdp": FSDP_RULES,
    "long_ctx": LONG_CTX_RULES,
    "mdgnn_replicated": MDGNN_REPLICATED_RULES,
    "mdgnn_event_dp": MDGNN_EVENT_DP_RULES,
    "mdgnn_event_dp_repl": MDGNN_EVENT_DP_REPL_RULES,
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names, or
    None; trailing Nones trimmed (as `jax.sharding.PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def logical_to_spec(axes: Sequence[str | None] | None,
                    rules: Mapping[str, Any],
                    mesh_axis_names: Sequence[str]) -> PartitionSpec:
    """Resolve a tuple of logical axis names to a PartitionSpec. Mesh axes
    absent from `mesh_axis_names` are dropped; a mesh axis is used at most
    once per spec, and a later dim that asks for it again falls back to
    replication."""
    if axes is None:
        return P()
    used: set[str] = set()
    out = []
    for ax in axes:
        entry = rules.get(ax) if ax is not None else None
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(n for n in names
                      if n in mesh_axis_names and n not in used)
        if not names:
            out.append(None)
        elif len(names) == 1:
            used.add(names[0])
            out.append(names[0])
        else:
            used.update(names)
            out.append(names)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_to_placements(spec: PartitionSpec, mesh_axis_names: Sequence[str]):
    """The DTensor placements of `spec`: one per mesh dim, `Shard(d)` where
    tensor dim d names that mesh axis, else `Replicate()`. A dim sharded
    over several mesh axes names them in mesh order (DTensor splits a dim
    over its mesh dims from the first to the last, as JAX's tuple order
    does from major to minor); another order raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axis_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(n) for n in group]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: dim {d} names mesh axes {group} out "
                             f"of the mesh's order {tuple(names)}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """A logical-axis tuple (names or None), the leaf of an axes tree."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None), tuple)) for e in x)


def map_axes(fn, tree):
    """fn over the leaves of an axes tree: nested dicts and dataclasses
    (MemoryState, PresState, PipelineState, EventBatch) whose leaves are
    logical-axis tuples."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_axes(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not an axes tree node: {tree!r}")


def tree_specs(axes_tree, rules: Mapping[str, Any], mesh):
    """PartitionSpecs of an axes tree on `mesh` (a DeviceMesh, or any
    object with `mesh_dim_names`)."""
    names = mesh.mesh_dim_names
    return map_axes(lambda ax: logical_to_spec(ax, rules, names), axes_tree)


def axes_placements(axes, rules: Mapping[str, Any], mesh):
    """The DTensor placements (a tuple, one per mesh dim) of one
    logical-axis tuple on `mesh`."""
    names = mesh.mesh_dim_names
    return spec_to_placements(logical_to_spec(axes, rules, names), names)


def tree_shardings(axes_tree, rules: Mapping[str, Any], mesh):
    """DTensor placements (a tuple, one per mesh dim) for every leaf of an
    axes tree on `mesh`."""
    return map_axes(lambda ax: axes_placements(ax, rules, mesh), axes_tree)
