"""CUDA graphs of the training and evaluation bodies: the port's stand-in
for the JAX package's `jax.jit` with donated carries, which compiles each
body into one device program (JAX `train/loop.py`'s train and eval steps,
`train/pipeline.py`'s pipelined step, `train/scan.py`'s macro step).

`StepGraphs` runs a step function `fn(carry, inputs) -> (carry, outputs)`
whose carry (parameters, optimizer state, model state, a snapshot) it
updates IN PLACE and whose inputs are per-step tensors (event batches).
On the card every body waits for nothing on the host on every route, so
a call is a replay of a graph captured once per key (the inputs' shapes
and dtypes, deterministic algorithms on or off, and what the caller
adds):

* the inputs are copied into static buffers of the graph, on the current
  stream (a batch made on the prefetch thread, `EventStream.
  prefetch_batches`, was copied to the card on the default stream, which
  every thread shares, before it was queued);
* the capture is preceded by one step on a side stream on clones of the
  carry (a registered generator restored after it), which prepares
  cuBLAS, autograd and the allocator without touching the carry;
* the graph is captured on the object's private memory pool with
  `capture_error_mode="thread_local"` (a prefetch thread may copy the
  next batches meanwhile); a carry leaf that the step returned in new
  storage (the optimizer's new moments) is copied back into the captured
  one at the end of the graph, so the carry keeps its addresses;
* a graph stays valid while the caller passes back the carry it was
  captured on (and the same generator); another carry is captured anew;
* a replay calls no kernel wrapper: the graph's launches, counted while
  it was captured (when no kernel runs) and taken back then, are added
  to the counters at every replay (`ops.add_launches`), as the serve
  engine does;
* the outputs are the graph's static tensors, overwritten by the next
  replay: the caller gets clones.

A capture that fails raises; nothing falls back to the eager body. A call
runs eagerly only for a static reason (`why_eager`): not on CUDA,
`capture=False`, a reason of the caller's (the scan engine's injected
negatives), shards on more than one device, or a torch that cannot
register a generator with a graph where one is registered. `captured` is
True once a call replayed a graph, False once one ran eagerly, None
before the first; `eager_reason` says why a call on CUDA ran eagerly
(None off CUDA)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.train import routing


def leaves(tree) -> list:
    """The tensors of a carry or of inputs, in a fixed order: dicts in
    key order, lists and tuples in order, dataclasses (model state,
    snapshot, event batches) field by field; other values (a host int
    such as the snapshot's tick) are not leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name))]
    return []


def clone(tree):
    """A copy of `tree` of the same structure whose tensors share no
    storage with it (detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(clone(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def why_eager(device: torch.device, capture: bool, cfg=None, state=None,
              generator=None, reason: str | None = None) -> str | None:
    """The static reason a call on `device` runs eagerly, or None: not
    on CUDA, `capture=False`, the caller's `reason`, a sharded state
    (cfg.n_shards > 1) on more than one device, a generator other than
    the device's default where this torch cannot register one with a
    graph."""
    if device.type != "cuda":
        return "not on CUDA"
    if not capture:
        return "capture=False"
    if reason is not None:
        return reason
    if (cfg is not None and cfg.n_shards > 1
            and len(set(routing.mesh_of(state))) > 1):
        return "the shards are on more than one device"
    if (generator is not None
            and generator is not torch.cuda.default_generators[device.index]
            and not hasattr(torch.cuda.CUDAGraph,
                            "register_generator_state")):
        return ("this torch cannot register a generator with a CUDA "
                "graph (CUDAGraph.register_generator_state)")
    return None


@dataclasses.dataclass
class _Graph:
    """One captured step: its static inputs, the graph, its static
    outputs and launch census, the carry and generator it was captured
    on."""
    inputs: Any
    graph: Any
    outputs: Any
    census: dict
    carry_ptrs: tuple
    generator: Any


class StepGraphs:
    """The CUDA graphs of one step function (see the module docstring).

        graphs = StepGraphs(capture)
        if graphs.eager(device, cfg, state):
            ...run the eager body...
        else:
            outputs = graphs.run(key, fn, carry, inputs)
    """

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.captured: bool | None = None
        self.eager_reason: str | None = None
        self._graphs: dict = {}
        self._pool = None

    def eager(self, device, cfg=None, state=None, generator=None,
              reason: str | None = None) -> bool:
        """Whether this call runs eagerly (`why_eager`); records
        `captured` and `eager_reason`."""
        device = torch.device(device)
        why = why_eager(device, self.capture, cfg, state, generator, reason)
        self.captured = why is None
        self.eager_reason = why if device.type == "cuda" else None
        return why is not None

    def run(self, key, fn: Callable, carry, inputs, generator=None,
            warm: Callable | None = None, warm_carry: Callable = clone):
        """Replay the graph of `key` on `inputs` (captured first on this
        carry and generator if it has none): `fn(carry, inputs) ->
        (carry, outputs)` updates `carry` in place; returns clones of the
        outputs. `warm` maps the static inputs to the warm-up step's (the
        scan engine warms up on one step of its macro); `warm_carry` maps
        the carry to the warm-up step's (a copy by default; the decode
        step copies its state but not its read-only parameters, which may
        fill most of the card)."""
        key = (key, tuple((tuple(x.shape), x.dtype)
                          for x in leaves(inputs)),
               torch.are_deterministic_algorithms_enabled())
        ptrs = tuple(t.data_ptr() for t in leaves(carry))
        g = self._graphs.get(key)
        if g is None or g.carry_ptrs != ptrs or g.generator is not generator:
            g = self._graphs[key] = self._capture(fn, carry, inputs, ptrs,
                                                  generator, warm, warm_carry)
        for buf, x in zip(leaves(g.inputs), leaves(inputs)):
            buf.copy_(x)
        g.graph.replay()
        kops.add_launches(g.census)
        return clone(g.outputs)

    def _capture(self, fn, carry, inputs, ptrs, generator, warm,
                 warm_carry) -> _Graph:
        dev = leaves(inputs)[0].device
        static = clone(inputs)
        # one step on copies of the carry (`warm_carry`), on a side stream,
        # leaving the generator and the launch counters as they were
        rng = generator.get_state() if generator is not None else None
        before = kops.launch_census()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(warm_carry(carry), static if warm is None else warm(static))
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        kops.add_launches(kops.launches_since(before), -1)
        if generator is not None:
            generator.set_state(rng)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if (generator is not None and generator
                is not torch.cuda.default_generators[dev.index]):
            graph.register_generator_state(generator)
        before = kops.launch_census()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            new, outputs = fn(carry, static)
            # the carry keeps its addresses: whatever the step returned in
            # new storage (the optimizer's state) is copied back
            for old, x in zip(leaves(carry), leaves(new)):
                if x.data_ptr() != old.data_ptr():
                    old.copy_(x)
        census = kops.launches_since(before)
        kops.add_launches(census, -1)
        return _Graph(static, graph, outputs, census, ptrs, generator)


class CapturedStep(StepGraphs):
    """A step of `cfg` run by its `StepGraphs` (the lag-one, pipelined and
    eval steps define `__call__`): `body` is the eager step, whose name
    and docstring the object takes, as a decorator's wrapper does."""

    def __init__(self, cfg, body, capture: bool = True):
        super().__init__(capture)
        self.cfg = cfg
        self.body = body
        functools.update_wrapper(self, body)
