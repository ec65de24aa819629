"""Distributed MDGNN training specs on a DeviceMesh (counterpart of
`repro/train/distributed.py`).

Sharding scheme (the JAX package's):
  * memory table, last-update times, PRES trackers, neighbour rings and
    APAN's mailbox: row-sharded over the ("pod", "data") mesh axes (the
    "nodes" logical axis);
  * temporal-batch events: sharded over the same axes ("event");
  * parameters: by their ("embed", "mlp") axes, "mlp" over "model".

JAX lowers such a spec with GSPMD shardings. PyTorch has no GSPMD: here
the spec's step runs on DTensors over a `DeviceMesh` and DTensor's own
sharding propagation puts in the collectives, which
`torch.distributed.tensor.debug.CommDebugMode` counts. Where DTensor has
no rule (data-dependent shapes, writes into tensors the step makes, the
kernels called through ctypes) the step runs on local tensors through
`train/annotate.py::local`, replicated, as GSPMD replicates around an op
it cannot shard.

`make_mdgnn_train_spec` gives a `LoweredSpec` (meta-device arguments and
their placements); `apply_spec` is the counterpart of `jax.jit(spec.fn,
in_shardings=..., out_shardings=...)` followed by a call: it distributes
real tensors by the spec's placements, runs the step and redistributes
its results. The executed multi-device path of the engines is
`train/routing.py` (`cfg.n_shards`); this module is what a DTensor
program of the same step looks like."""
from __future__ import annotations

import dataclasses
import functools
import typing

import torch

from repro_torch.graph.events import EventBatch
from repro_torch.launch.specs import LoweredSpec
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.nn import module as module_lib
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import annotate
from repro_torch.train import loop as loop_lib

STRATEGIES = ("gspmd", "compact_update", "optimized")


def _replicated(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def _meta_params(shapes):
    """Meta-device float32 parameters of a `param_shapes` tree."""
    if isinstance(shapes, dict):
        return {k: _meta_params(v) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=torch.float32, device="meta")


def event_batch_struct(batch_size: int, d_edge: int) -> EventBatch:
    """A meta-device EventBatch of `batch_size` events."""
    meta = functools.partial(torch.empty, device="meta")
    return EventBatch(src=meta((batch_size,), dtype=torch.int64),
                      dst=meta((batch_size,), dtype=torch.int64),
                      t=meta((batch_size,), dtype=torch.float32),
                      feat=meta((batch_size, d_edge), dtype=torch.float32),
                      mask=meta((batch_size,), dtype=torch.bool))


def event_batch_sharding(mesh, rules) -> EventBatch:
    """An EventBatch of placements: every column sharded on "event"."""
    s1 = module_lib.axes_placements(("event",), rules, mesh)
    s2 = module_lib.axes_placements(("event", None), rules, mesh)
    return EventBatch(src=s1, dst=s1, t=s1, feat=s2, mask=s1)


def macro_batch_struct(n_stacked: int, batch_size: int,
                       d_edge: int) -> EventBatch:
    """A meta-device stacked macro-batch: `n_stacked` consecutive temporal
    batches along a leading (scan) dim."""
    base = event_batch_struct(batch_size, d_edge)
    return annotate.map_tensors(lambda t: torch.empty((n_stacked,) + t.shape,
                                               dtype=t.dtype, device="meta"),
                         base)


def macro_batch_sharding(mesh, rules) -> EventBatch:
    """Stacked batches shard like per-batch events, one dim deeper: the
    scan dim unsharded, the event dim dim 1."""
    s1 = module_lib.axes_placements((None, "event"), rules, mesh)
    s2 = module_lib.axes_placements((None, "event", None), rules, mesh)
    return EventBatch(src=s1, dst=s1, t=s1, feat=s2, mask=s1)


def make_mdgnn_train_spec(cfg: MDGNNConfig, batch_size: int, mesh,
                          rules=None, strategy: str = "gspmd") -> LoweredSpec:
    """The train step of `cfg` as a LoweredSpec on `mesh`.

    strategy:
      "gspmd"          node-sharded state; DTensor's propagation inserts
                       the memory gather / scatter collectives.
      "compact_update" the state tables replicated (rules default to
                       "mdgnn_replicated") and the compact per-occurrence
                       update arrays replicated at the scatter boundaries
                       (`annotate.compact`), so the table scatters are
                       local; per-occurrence tensors pinned to the event
                       axes (`annotate.events`).
      "optimized"      `annotate.events` only, with the caller's rules
                       (JAX pairs it with "mdgnn_event_dp_repl").

    The step is the lag-one body; with cfg.pipeline_depth >= 1 the
    pipelined step, which carries the PipelineState snapshot sharded like
    the table; with cfg.scan_chunk > 1 the macro step over a stacked
    (T+1, b, ...) macro-batch, its negatives drawn from a generator.
    Every variant names the optimizer and model state as donated."""
    from repro_torch.train import scan as scan_lib

    scan_lib.check_schedule(cfg)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{STRATEGIES}")
    if strategy == "compact_update" and rules is None:
        rules = dict(module_lib.RULE_SETS["mdgnn_replicated"])
    rules = rules or dict(module_lib.DEFAULT_RULES)
    opt = opt_lib.adamw(1e-3)

    param_shapes = _meta_params(mdgnn.param_shapes(cfg))
    param_axes = mdgnn.param_axes(cfg)
    opt_shapes = opt.init(param_shapes)
    opt_axes = opt.state_axes(param_axes)
    state_shapes = mdgnn.init_state(cfg, device="meta")
    state_axes = {k: mdgnn.STATE_AXES[k] for k in state_shapes}

    p_shard = module_lib.tree_shardings(param_axes, rules, mesh)
    o_shard = module_lib.tree_shardings(opt_axes, rules, mesh)
    s_shard = module_lib.tree_shardings(state_axes, rules, mesh)
    b_shard = event_batch_sharding(mesh, rules)
    repl = _replicated(mesh)

    pipelined = cfg.pipeline_depth >= 1
    scanned = cfg.scan_chunk > 1
    train_step_fn = _make_raw_train_step(cfg, opt, mesh=mesh,
                                         strategy=strategy, rules=rules,
                                         pipelined=pipelined,
                                         scanned=scanned)
    batch = event_batch_struct(batch_size, cfg.d_edge)

    if scanned:
        macro = macro_batch_struct(cfg.scan_chunk + 1, batch_size,
                                   cfg.d_edge)
        m_shard = macro_batch_sharding(mesh, rules)
        # the generator (on the mesh's device) takes the place of JAX's key
        return LoweredSpec(
            fn=train_step_fn,
            args=(param_shapes, opt_shapes, state_shapes, None, macro),
            in_shardings=(p_shard, o_shard, s_shard, repl, m_shard),
            out_shardings=(p_shard, o_shard, s_shard, repl),
            donate_argnums=(1, 2),
        )

    if pipelined:
        from repro_torch.train import pipeline as pipeline_lib
        pstate_shapes = pipeline_lib.PipelineState.init(
            state_shapes["memory"])
        ps_shard = module_lib.tree_shardings(
            pipeline_lib.PIPELINE_STATE_AXES, rules, mesh)
        return LoweredSpec(
            fn=train_step_fn,
            args=(param_shapes, opt_shapes, state_shapes, pstate_shapes,
                  batch, batch, batch),
            in_shardings=(p_shard, o_shard, s_shard, ps_shard,
                          b_shard, b_shard, b_shard),
            out_shardings=(p_shard, o_shard, s_shard, ps_shard, repl),
            donate_argnums=(1, 2, 3),
        )

    return LoweredSpec(
        fn=train_step_fn,
        args=(param_shapes, opt_shapes, state_shapes, batch, batch, batch),
        in_shardings=(p_shard, o_shard, s_shard, b_shard, b_shard, b_shard),
        out_shardings=(p_shard, o_shard, s_shard, repl),
        donate_argnums=(1, 2),
    )


def _metrics(m) -> dict:
    """The step's metrics the spec returns (JAX's spec returns the loss;
    the port adds the logits, which its checks compare too)."""
    return {k: m[k] for k in ("loss", "logit_p", "logit_n")}


def _make_raw_train_step(cfg: MDGNNConfig, opt, mesh=None,
                         strategy: str = "gspmd", rules=None,
                         pipelined: bool = False, scanned: bool = False):
    """The step on DTensors, with the annotate hooks of `strategy`
    installed for the duration of its body: lag-one, pipelined (with the
    PipelineState argument) or scanned (over a stacked macro-batch, with
    an optional `negatives` list of injected batches). The last result
    is a dict of the loss and logits; the scanned step's loss is the mean
    of its T losses, which it also returns stacked as "losses"."""

    def _event_sharding(x):
        """Pin a per-occurrence tensor's leading dim to the event axes."""
        if not annotate.is_dtensor(x):
            return x
        pl = module_lib.axes_placements(("event",) + (None,) * (x.ndim - 1),
                                        rules, mesh)
        return x.redistribute(mesh, pl)

    def _compact(x):
        if not annotate.is_dtensor(x):
            return x
        return x.redistribute(mesh, _replicated(mesh))

    def _hooks():
        hooks = {}
        if strategy == "compact_update":
            hooks["compact_fn"] = _compact
        if strategy in ("compact_update", "optimized") and rules is not None:
            hooks["events_fn"] = _event_sharding
        return hooks

    def _run_hooked(fn, args, **kw):
        with annotate.install(**_hooks()):
            return fn(*args, **kw)

    def train_step(params, opt_state, state, prev_batch, pos, neg):
        fn = loop_lib.make_step_body(cfg, opt)
        out = _run_hooked(fn, (params, opt_state, state, prev_batch, pos,
                               neg))
        return out[:-1] + (_metrics(out[-1]),)

    def pipelined_train_step(params, opt_state, state, pstate, prev_batch,
                             pos, neg):
        from repro_torch.train import pipeline as pipeline_lib
        # the body itself, as for the lag-one step: DTensors, not a graph
        fn = pipeline_lib.make_pipelined_train_step(cfg, opt, capture=False)
        out = _run_hooked(fn, (params, opt_state, state, pstate, prev_batch,
                               pos, neg))
        return out[:-1] + (_metrics(out[-1]),)

    def scanned_train_step(params, opt_state, state, generator, macro,
                           negatives=None):
        from repro_torch.train import scan as scan_lib
        if negatives is not None:
            b_shard = event_batch_sharding(mesh, rules)
            negatives = [distribute_tree(n, b_shard, mesh)
                         for n in negatives]
        # dst bounds are the full node range, as JAX's spec takes them
        fn = scan_lib.make_macro_step(cfg, opt, (0, cfg.n_nodes))
        out = _run_hooked(fn, (params, opt_state, state, generator, macro),
                          negatives=negatives)
        m = out[-1]
        return out[:-1] + ({"loss": m["loss"].mean(), "losses": m["loss"],
                            "logit_p": m["logit_p"],
                            "logit_n": m["logit_n"]},)

    if scanned:
        return scanned_train_step
    return pipelined_train_step if pipelined else train_step


# ---------------------------------------------------------------------------
# Applying a spec to real tensors
# ---------------------------------------------------------------------------


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(p, Placement) for p in x)


def _zip_map(fn, tree, shardings):
    """fn(leaf, placements) over the tensors of `tree`; `shardings` has
    `tree`'s layout, or a placements tuple where a whole subtree shares
    one."""
    if _is_placements(shardings):
        return annotate.map_tensors(lambda t: fn(t, shardings), tree)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, shardings))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _zip_map(fn, getattr(tree, f.name),
                             getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def distribute_tree(tree, shardings, mesh):
    """Every tensor of `tree` as a DTensor of its placements: a plain
    tensor is taken as the whole value on every rank (its local shard cut
    from it, no communication; it may share storage with the DTensor), a
    DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(t, pl):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t.detach(), mesh, list(pl),
                                 src_data_rank=None)

    return _zip_map(put, tree, shardings)


def apply_spec(spec: LoweredSpec, mesh, *args, **kw):
    """Run `spec.fn` on real arguments laid out by `spec.in_shardings` and
    return its results redistributed to `spec.out_shardings` (DTensors;
    `full_tree` gathers them). The counterpart of `jax.jit(spec.fn,
    in_shardings=..., out_shardings=...)(*args)`. The donated arguments'
    storage is updated in place."""
    dargs = tuple(distribute_tree(a, s, mesh)
                  for a, s in zip(args, spec.in_shardings))
    out = spec.fn(*dargs, **kw)
    return _zip_map(lambda t, pl: t.redistribute(mesh, pl), out,
                    spec.out_shardings)


def full_tree(tree):
    """A detached copy of the whole value of every DTensor of `tree` (a
    collective: every rank calls it; on a mesh of one device the whole
    value is the local storage, which a later in-place step would
    change); plain tensors as they are."""
    from torch.distributed.tensor import DTensor
    return annotate.map_tensors(lambda t: t.full_tensor().detach().clone()
                         if isinstance(t, DTensor) else t, tree)


class Collective(typing.NamedTuple):
    """One collective of a `collective_log`: the functional op's name
    ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
    "all_to_all_single", ...), the shape of the local tensor it takes,
    whether the backward pass issued it, the shape and dtype of the local
    tensor it gives, and its process group's name."""
    name: str
    shape: tuple
    in_backward: bool
    out_shape: tuple
    dtype: torch.dtype
    group: str


def collective_log():
    """A `CommDebugMode` that also keeps every collective in `.shapes`, a
    list of `Collective`s (the counterpart of the dry run's HLO collective
    sizes): `with collective_log() as log:` ... `log.get_comm_counts()`,
    `log.shapes`."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            space, _, op = str(func.overloadpacket).rpartition(".")
            if space in ("c10d_functional", "_c10d_functional") \
                    and op.startswith(("all_", "reduce_scatter",
                                       "broadcast")) and args \
                    and isinstance(args[0], torch.Tensor) \
                    and isinstance(out, torch.Tensor):
                self.shapes.append(Collective(
                    op, tuple(args[0].shape),
                    torch._C._current_graph_task_id() != -1,
                    tuple(out.shape), out.dtype,
                    args[-1] if isinstance(args[-1], str) else ""))
            return out

    return CollectiveLog()
