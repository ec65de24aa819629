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
shape, JAX's one dispatch per T batches: the batch is copied into static
buffers, the graph replays the T forward, backward and AdamW steps, and
the carry (parameters, optimizer state, model state) keeps its addresses
(parameters and state are updated in place; the optimizer's new state is
copied back into the captured one at the end of the graph). The
generator is registered with the graph, so every replay draws fresh
negatives in the eager order. The capture machinery (static buffers, the
warm-up step on copies of the carry, here a macro of one step, the
copy-back, the recapture on another carry, the launch census added at
every replay) is train/capture.py's, which the lag-one, pipelined and
eval steps share. A macro with injected negatives runs eagerly, as does
every macro on the CPU and with `capture=False`. A sharded state
(cfg.n_shards > 1, train/routing.py) captures the same way when its
shards share one card: the routing protocol waits for nothing on the
host, and its fused route updates every shard's table in place. Shards
on several cards run eagerly. `ScanEngine.captured` says which ran.

`cfg.scan_chunk = 1` delegates to `loop.run_epoch` verbatim. `scan_chunk`
and `pipeline_depth` are mutually exclusive (`check_schedule`)."""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.graph.events import EventBatch, iter_macro_batches
from repro_torch.graph.negatives import sample_negatives_in
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import annotate
from repro_torch.train import capture as capture_lib
from repro_torch.train import loop as loop_lib

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
    return capture_lib.leaves(state)


class ScanEngine(capture_lib.StepGraphs):
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
        super().__init__(capture)
        self.cfg = cfg
        self.opt = opt
        self.step_hook = step_hook
        self.negatives: list = []
        self._macro_steps: dict = {}

    # ------------------------------------------------------------------ #

    @functools.cached_property
    def _seq_step(self):
        step = loop_lib.make_train_step(self.cfg, self.opt,
                                        capture=self.capture)
        return step if self.step_hook is None else self.step_hook(step)

    def _eager_step(self, dst_range):
        if dst_range not in self._macro_steps:
            self._macro_steps[dst_range] = make_macro_step(
                self.cfg, self.opt, dst_range)
        return self._macro_steps[dst_range]

    def _macro(self, params, opt_state, state, generator, macro, dst_range,
               negatives=None):
        step = self._eager_step(dst_range)
        if self.eager(macro.src.device, self.cfg, state, generator,
                              "negatives injected" if negatives is not None
                              else None):
            return step(params, opt_state, state, generator, macro,
                        negatives)

        def fn(carry, inputs):
            *carry, metrics = step(*carry, generator, *inputs)
            return carry, metrics

        # the warm-up step runs a macro of one step
        first = lambda inputs: (EventBatch(*(getattr(inputs[0], f)[:2]
                                             for f in _FIELDS)),)
        metrics = self.run(dst_range, fn, (params, opt_state, state),
                                   (macro,), generator, warm=first)
        return params, opt_state, state, metrics

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
