"""Macro-batch training (counterpart of `repro/train/scan.py`).

The lag-one loop (train/loop.py) runs one step per temporal batch from
Python: its host work and launches hold the card back in small-batch
regimes (CONFIG's steps keep it 6-11 % busy). This engine runs T lag-one
steps as one macro step:

* T consecutive temporal batches are stacked into one (T+1, b, ...)
  macro-batch (`events.iter_macro_batches`: macros overlap by one batch,
  because batch i-1 updates the memory that predicts batch i);
* one macro step runs the step body (`loop.make_step_body`) T times, with
  the negatives drawn inside it from the carried generator
  (`negatives.sample_negatives_in`), in the host loop's order, so a macro
  draws the lag-one loop's negatives;
* per-step metrics come back stacked on the device ({loss (T,), logit_p
  (T, b), logit_n (T, b), neg_dst (T, b), obs (T, F)}) and stay there
  until the epoch ends.

On the card the step waits for nothing on the host on every route (the
fused `memory_update_table` kernel with PRES, the GRU cell and kernels;
the cell route's fixed-shape row writes, `batching.write_selected`,
otherwise), so the T steps are captured as ONE CUDA graph per (T, b)
shape, JAX's one dispatch per T batches: the batch is copied
into static buffers, the graph replays the T forward, backward and AdamW
steps, and the carry (parameters, optimizer state, model state) keeps its
addresses (parameters and state are updated in place; the optimizer's
new state is copied back into the captured one at the end of the graph).
The generator is registered with the graph, so every replay draws fresh
negatives in the eager order. A replay calls no kernel wrapper: the
graph's launches, counted at capture, are added to the counters at every
replay (`ops.add_launches`), as the serve engine does. The capture is
preceded by one step on a side stream on copies of the carry (the
generator restored after it), which prepares cuBLAS, autograd and the
allocator without touching the carry. A graph stays valid while the
caller passes back the carry it returned; another carry is captured anew.
A macro with injected negatives runs eagerly, as does every macro on the
CPU and with `capture=False`. A sharded state (cfg.n_shards > 1,
train/routing.py) captures the same way when its shards share one card:
the routing protocol waits for nothing on the host, and its fused route
updates every shard's table in place. Shards on several cards run
eagerly. `ScanEngine.captured` says which ran.

`cfg.scan_chunk = 1` delegates to `loop.run_epoch` verbatim. `scan_chunk`
and `pipeline_depth` are mutually exclusive (`check_schedule`)."""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from repro_torch.graph.events import EventBatch, iter_macro_batches
from repro_torch.graph.negatives import sample_negatives_in
from repro_torch.kernels import ops as kops
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import annotate
from repro_torch.train import loop as loop_lib
from repro_torch.train import routing
from repro_torch.utils.tree import tree_leaves, tree_map

_FIELDS = ("src", "dst", "t", "feat", "mask")


def check_schedule(cfg: MDGNNConfig) -> None:
    """scan_chunk >= 1, and scan_chunk > 1 excludes pipeline_depth >= 1."""
    if cfg.scan_chunk < 1:
        raise ValueError(f"scan_chunk must be >= 1, got {cfg.scan_chunk}")
    if cfg.scan_chunk > 1 and cfg.pipeline_depth >= 1:
        raise ValueError(
            "scan_chunk > 1 and pipeline_depth >= 1 are mutually exclusive: "
            "the macro-batch engine runs the strictly sequential lag-one "
            "body, while the pipelined schedule threads a snapshot through "
            "every step. Pick one: scan_chunk for host-bound (small-batch) "
            "regimes, pipeline_depth for memory/embed overlap")


def make_macro_step(cfg: MDGNNConfig, opt, dst_range):
    """The eager macro step: macro_step(params, opt_state, state,
    generator, macro, negatives=None) -> (params, opt_state, state,
    metrics), `macro` a stacked (T+1, b, ...) EventBatch and `negatives`
    None (drawn in the step) or T injected batches. `metrics` holds the T
    per-step values stacked on the device."""
    check_schedule(cfg)
    body = loop_lib.make_step_body(cfg, opt)
    dst_lo, dst_hi = dst_range

    def macro_step(params, opt_state, state, generator, macro: EventBatch,
                   negatives=None):
        steps = []
        for i in range(macro.src.shape[0] - 1):
            pos = macro.at(i + 1)
            neg = (negatives[i] if negatives is not None else
                   annotate.local(sample_negatives_in, generator, pos,
                                  dst_lo, dst_hi))
            params, opt_state, state, m = body(params, opt_state, state,
                                               macro.at(i), pos, neg)
            m["neg_dst"] = neg.dst
            steps.append(m)
        metrics = {k: torch.stack([m[k] for m in steps])
                   for k, v in steps[0].items() if isinstance(v, torch.Tensor)}
        return params, opt_state, state, metrics

    return macro_step


def _state_leaves(state) -> list:
    """Every tensor of a model state (each shard's of a sharded one), in a
    fixed order."""
    mem, pr = state["memory"], state["pres"]
    out = [mem.mem, mem.last_update, *state["neighbors"].values(),
           pr.n, pr.xi, pr.psi]
    if "mailbox" in state:
        out += list(state["mailbox"].values())
    return [t for x in out for t in (x if isinstance(x, list) else [x])]


def _carry_leaves(params, opt_state, state) -> list:
    return tree_leaves(params) + tree_leaves(opt_state) + _state_leaves(state)


def _clone_carry(params, opt_state, state):
    return (tree_map(lambda t: t.detach().clone(), params),
            tree_map(lambda t: t.clone(), opt_state),
            mdgnn.clone_state(state))


@dataclasses.dataclass
class _Graph:
    """One captured macro step: the static macro-batch, the graph, its
    static outputs and launch census, and the carry it was captured on."""
    macro: EventBatch
    graph: Any
    outputs: dict
    census: dict
    carry_ptrs: tuple
    generator: torch.Generator


class ScanEngine:
    """Epoch runner of macro-batch training. Use like loop.run_epoch:

        engine = ScanEngine(cfg, opt)
        params, opt_state, state, res = engine.run_epoch(
            params, opt_state, state, batches, generator, dst_range)

    `step_hook` wraps each macro-step call (the launch CLI's bounded
    profiler window, obs.trace.StepTraceCapture.wrap). `capture=False`
    runs every macro eagerly on the card too. `captured` is True once a
    macro step ran as a CUDA graph, False once one ran eagerly, None
    before the first; `eager_reason` says why a macro on CUDA ran
    eagerly. `negatives` holds the last epoch's negative destinations
    ((T, b) device tensors a macro), by which a captured epoch's draws
    are held against an eager one's."""

    def __init__(self, cfg: MDGNNConfig, opt, step_hook=None,
                 capture: bool = True):
        check_schedule(cfg)
        self.cfg = cfg
        self.opt = opt
        self.step_hook = step_hook
        self.capture = capture
        self.captured: bool | None = None
        self.eager_reason: str | None = None
        self.negatives: list = []
        self._macro_steps: dict = {}
        self._graphs: dict = {}
        self._pool = None

    # ------------------------------------------------------------------ #

    @functools.cached_property
    def _seq_step(self):
        step = loop_lib.make_train_step(self.cfg, self.opt)
        return step if self.step_hook is None else self.step_hook(step)

    def _eager_step(self, dst_range):
        if dst_range not in self._macro_steps:
            self._macro_steps[dst_range] = make_macro_step(
                self.cfg, self.opt, dst_range)
        return self._macro_steps[dst_range]

    def _why_eager(self, macro: EventBatch, state, generator, negatives):
        if macro.src.device.type != "cuda":
            return "not on CUDA"
        if not self.capture:
            return "capture=False"
        if negatives is not None:
            return "negatives injected"
        if (self.cfg.n_shards > 1
                and len(set(routing.mesh_of(state))) > 1):
            return "the shards are on more than one device"
        default = torch.cuda.default_generators[macro.src.device.index]
        if (generator is not default and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state")):
            return ("this torch cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state)")
        return None

    def _macro(self, params, opt_state, state, generator, macro, dst_range,
               negatives=None):
        reason = self._why_eager(macro, state, generator, negatives)
        if reason is not None:
            self.captured = False
            self.eager_reason = reason if macro.src.is_cuda else None
            return self._eager_step(dst_range)(params, opt_state, state,
                                               generator, macro, negatives)
        self.captured = True
        g = self._graph(params, opt_state, state, generator, macro,
                        dst_range)
        for f in _FIELDS:
            getattr(g.macro, f).copy_(getattr(macro, f))
        g.graph.replay()
        kops.add_launches(g.census)
        return params, opt_state, state, {k: v.clone()
                                          for k, v in g.outputs.items()}

    def _graph(self, params, opt_state, state, generator, macro, dst_range):
        """The graph of this (T, b) shape, captured on this carry (again
        if the carry or the generator is another)."""
        key = (tuple(macro.src.shape), tuple(macro.feat.shape), dst_range)
        ptrs = tuple(t.data_ptr()
                     for t in _carry_leaves(params, opt_state, state))
        g = self._graphs.get(key)
        if g is not None and g.carry_ptrs == ptrs and g.generator is generator:
            return g
        dev = macro.src.device
        step = self._eager_step(dst_range)
        static = EventBatch(*(torch.empty_like(getattr(macro, f))
                              for f in _FIELDS))
        for f in _FIELDS:
            getattr(static, f).copy_(getattr(macro, f))
        # one step on copies of the carry, on a side stream, leaving the
        # generator and the launch counters as they were
        rng = generator.get_state()
        before = kops.launch_census()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = EventBatch(*(getattr(static, f)[:2] for f in _FIELDS))
            step(*_clone_carry(params, opt_state, state), generator, first)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        kops.add_launches(kops.launches_since(before), -1)
        generator.set_state(rng)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if generator is not torch.cuda.default_generators[dev.index]:
            graph.register_generator_state(generator)
        before = kops.launch_census()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            p2, o2, s2, outputs = step(params, opt_state, state, generator,
                                       static)
            # the carry keeps its addresses: whatever the steps returned in
            # new storage (the optimizer's state) is copied back
            for old, new in zip(_carry_leaves(params, opt_state, state),
                                _carry_leaves(p2, o2, s2)):
                if new.data_ptr() != old.data_ptr():
                    old.copy_(new)
        census = kops.launches_since(before)
        kops.add_launches(census, -1)
        g = _Graph(static, graph, outputs, census, ptrs, generator)
        self._graphs[key] = g
        return g

    # ------------------------------------------------------------------ #

    def run_epoch(self, params, opt_state, state, batches, generator,
                  dst_range, negatives=None, collect_logits=False):
        """One epoch over `batches` (a list or an iterator; a prefetch
        iterator is closed at the end). Negatives are drawn from
        `generator` inside the macro steps unless `negatives` gives one
        batch per step (then the macros run eagerly)."""
        dst_range = tuple(dst_range)
        if self.cfg.scan_chunk == 1:
            return loop_lib.run_epoch(params, opt_state, state, batches,
                                      self.cfg, self._seq_step, generator,
                                      dst_range, negatives=negatives,
                                      collect_logits=collect_logits)
        t0 = time.perf_counter()
        step = functools.partial(self._macro, dst_range=dst_range)
        if self.step_hook is not None:
            step = self.step_hook(step)
        losses, pos_all, neg_all, kept = [], [], [], []
        obs = obs_metrics.EpochObs()
        negs = None if negatives is None else iter(negatives)
        it = iter_macro_batches(batches, self.cfg.scan_chunk)
        try:
            for macro in it:
                chunk = None
                if negs is not None:
                    chunk = [loop_lib._negatives(negs, None, None, None)
                             for _ in range(macro.src.shape[0] - 1)]
                params, opt_state, state, m = step(
                    params, opt_state, state, generator, macro,
                    negatives=chunk)
                losses.append(m["loss"])
                pos_all.append(m["logit_p"])
                neg_all.append(m["logit_n"])
                kept.append(m["neg_dst"])
                obs.step(m)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        self.negatives = kept
        return params, opt_state, state, loop_lib.epoch_result(
            losses, pos_all, neg_all, t0, collect_logits, obs)
