"""Sharding-annotation hooks for the distributed MDGNN step (counterpart
of `repro/train/annotate.py`).

The JAX package marks three kinds of tensor for its GSPMD spec:

* `compact(x)`: a compact per-occurrence array at a scatter boundary, so
  the spec can re-shard it explicitly (the `compact_update` strategy
  replicates it, and the table scatters stay local);
* `events(x)`: a per-occurrence tensor whose leading dim the spec pins to
  the event axes (gathers from a replicated table would otherwise come
  out replicated);
* `weights(x)`: a weight leaf that the zoo's FSDP spec gathers before use.

In the port the spec's step runs on DTensors over a `DeviceMesh`
(`train/distributed.py`) and the installed hooks redistribute. All three
are the identity unless a hook is installed, and the spec installs them
only for the duration of its step body. The hooks are thread-local, so
the ranks of a threaded process group each install their own.

`local(fn, *args)` is the port's counterpart of GSPMD replicating around
an op it cannot shard. DTensor has no sharding rule for data-dependent
shapes (`unique`, a boolean-mask index), for a write into a plain
tensor that the step makes itself, or for a kernel called through
`ctypes`. Where its arguments hold DTensors, `local` redistributes them
to the given placements (replicated by default), calls `fn` on their
local tensors and wraps the tensors it returns back as DTensors of those
placements. Autograd passes through the redistribution and the wrapping.
An argument that takes no gradient reaches `fn` as a detached alias of
its local storage, which `fn` may write in place. Arguments at the
positions in `writes` are state that `fn` updates in place: their local
copies are written back to the DTensors' own shards.
On plain tensors `local` calls `fn` directly, so the single-device path
runs the same ops as before, CUDA graphs included.

The zoo's specs (`launch/specs.py`) add: `group_placements` (the batch
and head shards a `local` call of attention or of the linear recurrence
keeps), `split_dim` (a reshape that gathers a dim DTensor cannot split),
`replicate`, and `write_index` (a KV-cache write on the shard that owns
the position). Each is the plain op on plain tensors."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading

import torch

_state = threading.local()


def compact(x):
    """Annotate a compact per-occurrence array at a scatter boundary."""
    fn = getattr(_state, "compact_fn", None)
    return fn(x) if fn is not None else x


def events(x):
    """Annotate a per-occurrence tensor (leading dim = occurrences)."""
    fn = getattr(_state, "events_fn", None)
    return fn(x) if fn is not None else x


def weights(x):
    """Annotate a weight leaf (the zoo's FSDP weight-gather hook)."""
    fn = getattr(_state, "weights_fn", None)
    return fn(x) if fn is not None else x


@contextlib.contextmanager
def install(compact_fn=None, events_fn=None, weights_fn=None):
    """Install hooks for the duration of the block; the previous ones (or
    none) come back on exit."""
    prev = (getattr(_state, "compact_fn", None),
            getattr(_state, "events_fn", None),
            getattr(_state, "weights_fn", None))
    if compact_fn is not None:
        _state.compact_fn = compact_fn
    if events_fn is not None:
        _state.events_fn = events_fn
    if weights_fn is not None:
        _state.weights_fn = weights_fn
    try:
        yield
    finally:
        (_state.compact_fn, _state.events_fn, _state.weights_fn) = prev


# ---------------------------------------------------------------------------
# Local execution around ops that DTensor cannot shard
# ---------------------------------------------------------------------------


def map_tensors(fn, tree):
    """fn over the tensor leaves of nested dicts, lists, tuples and
    dataclasses (MemoryState, PresState, EventBatch); other leaves kept."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _first(cls, tree):
    """The first leaf of `tree` (as `map_tensors` walks it) of type `cls`, or
    None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        for v in tree:
            hit = _first(cls, v)
            if hit is not None:
                return hit
        return None
    return tree if isinstance(tree, cls) else None


def _dtensor_type():
    """DTensor's class, or None while its module is not imported (then no
    DTensor exists, and the single-device path pays no import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_dtensor(x) -> bool:
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


def _plain(t):
    """A local tensor ready for any op: an async collective's result is
    waited for (a kernel called through ctypes reads its storage)."""
    wait = getattr(t, "wait", None)
    return wait() if callable(wait) else t


def local(fn, *args, placements=None, writes=(), whole=(), **kw):
    """fn(*args, **kw) on local tensors (see the module docstring).

    placements: the DTensor placements (one per mesh dim) that the
    arguments are redistributed to and the results carry (plain tensor
    arguments taken as replicated); default Replicate on every dim, plain
    tensor arguments passed as they are. writes: positions of arguments
    whose DTensor leaves `fn` updates in place, written back to the
    leaves' own placements (without autograd) after the call; they take
    no gradient. whole: positions of arguments (small weights beside a
    batch-sharded input) that reach `fn` replicated whatever `placements`
    says; their gradients are partial sums over the mesh dims
    `placements` shards."""
    dtensor = _dtensor_type()
    found = _first(dtensor, (args, kw)) if dtensor is not None else None
    if found is None:
        return fn(*args, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = found.device_mesh
    repl = (Replicate(),) * mesh.ndim
    pl = tuple(placements or repl)
    partial = [Partial() if isinstance(p, Shard) else Replicate()
               for p in pl]
    pairs = []   # (DTensor leaf of a written argument, its local copy)

    def to_local(t, written=False, is_whole=False):
        if not isinstance(t, DTensor):
            if placements is None or is_whole:
                return t
            # a plain tensor is the whole value on every rank: its shard
            t = DTensor.from_local(t, mesh, repl, run_check=False)
        d = t.redistribute(mesh, repl if is_whole else pl)
        loc = _plain(d.to_local(grad_placements=partial) if is_whole
                     else d.to_local())
        if not d.requires_grad:
            # a detached alias of the local storage, which `fn` may write
            # in place under autograd (a view made by to_local may not be)
            loc = loc.detach()
        if written:
            pairs.append((t, loc))
        return loc

    local_args = [map_tensors(lambda t, w=(i in writes), h=(i in whole):
                              to_local(t, w, h), a)
                  for i, a in enumerate(args)]
    out = fn(*local_args, **map_tensors(to_local, kw))
    with torch.no_grad():
        for t, loc in pairs:
            own = t.to_local()
            if own.data_ptr() == loc.data_ptr():
                continue        # a replicated leaf was written in place
            back = DTensor.from_local(loc.detach(), mesh, pl,
                                      run_check=False)
            own.copy_(_plain(back.redistribute(mesh, t.placements)
                             .to_local()))
    return map_tensors(
        lambda t: DTensor.from_local(t, mesh, pl, run_check=False), out)


def _unsharded_placements(t, dim: int):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in t.placements]


def replicate(x):
    """A DTensor `x` whole on every rank; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _dim_range(t, dim: int) -> tuple[int, int]:
    """[start, stop) of `t`'s dim `dim` that this rank's shard of the
    DTensor `t` holds: the dim is split over its Shard(dim) mesh dims in
    the mesh's order, each split as `torch.chunk` splits (DTensor's
    layout)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    start, length = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // mesh.size(i))
            lo = min(coord[i] * chunk, length)
            start, length = start + lo, min(chunk, length - lo)
    return start, start + length


def write_index(dst, dim: int, index: int, value) -> None:
    """dst[(:,) * dim + (index,)] = value, in place, without autograd.
    On a DTensor `dst` only the rank whose shard holds `index` along
    `dim` writes, into its local shard (a KV cache sharded on its
    sequence dim, long_500k's rules, is not gathered for it); `value` is
    redistributed to dst's placements on the other dims first."""
    with torch.no_grad():
        if not is_dtensor(dst):
            dst.select(dim, index).copy_(value)
            return
        from torch.distributed.tensor import DTensor, Replicate
        pl = _unsharded_placements(dst, dim)
        if not is_dtensor(value):
            value = DTensor.from_local(value, dst.device_mesh,
                                       [Replicate()] * dst.device_mesh.ndim,
                                       run_check=False)
        row = _plain(value.unsqueeze(dim).redistribute(
            dst.device_mesh, pl).to_local())
        lo, hi = _dim_range(dst, dim)
        if lo <= index < hi:
            dst.to_local().select(dim, index - lo).copy_(row.select(dim, 0))


def split_dim(x, dim: int, sizes):
    """x with dim `dim` unflattened into `sizes` (a reshape). DTensor
    cannot split a sharded dim whose first part does not divide over its
    shards (qwen3's 8 kv heads on a 16-wide "model" axis): such a dim is
    gathered first, its other placements kept."""
    dim = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        ranks = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == dim:
                ranks *= x.device_mesh.size(i)
        if sizes[0] % ranks:
            x = x.redistribute(x.device_mesh, _unsharded_placements(x, dim))
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def group_placements(args, dims):
    """Placements for a function of independent groups along `dims` of
    every tensor in `args` (the batch and head dims of attention and of
    the linear recurrence): on each mesh dim, the first DTensor's Shard of
    one of `dims` where that dim of every tensor divides over all the mesh
    dims sharding it, else Replicate; None when no argument is a
    DTensor."""
    dtensor = _dtensor_type()
    first = _first(dtensor, args) if dtensor is not None else None
    if first is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    mesh = first.device_mesh
    tensors = []
    map_tensors(tensors.append, args)
    pl = list(first.placements)
    for d in dims:
        on = [i for i, p in enumerate(pl) if isinstance(p, Shard)
              and p.dim == d]
        ranks = 1
        for i in on:
            ranks *= mesh.size(i)
        if any(t.shape[d] % ranks for t in tensors):
            for i in on:
                pl[i] = Replicate()
    return tuple(p if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in pl)
