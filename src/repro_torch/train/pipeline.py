"""Staleness-aware pipelined training schedule (counterpart of
`repro/train/pipeline.py`).

The MEMORY stage writes the live table exactly as the lag-one step does
(`loop.memory_and_pres`, PRES fusion included). The EMBEDDING stage reads
a snapshot of the table refreshed every `cfg.pipeline_depth` steps, so a
row it reads is at most `pipeline_depth` batch-writes stale, and the rows
whose writes are still in flight are filled with the PRES Eq. 7
prediction (`stale_read_table`: the `pres_predict` kernel with
cfg.use_kernels, `pres.predict` without). The
coherence term (Eq. 10) is the only gradient path from the loss to the
memory and message parameters, so the step refuses to run without it.

`pipeline_depth=0` is the lag-one schedule: `make_train_step` and
`run_epoch` delegate to `train/loop.py` unchanged.

With cfg.obs_metrics the step's obs vector carries the snapshot's
staleness (obs/metrics.py). Like the lag-one step, the pipelined step
updates the state, the snapshot,
the parameters and the optimizer moments IN PLACE. The snapshot holds
copies of the live table, never aliases: the memory stage writes the live
table in place, so an alias would make the snapshot live.

With cfg.n_shards > 1 the live tables are sharded (train/routing.py) and
the snapshot stays in the natural layout on the controller: the shard
exchange happens in the live memory stage, the embedding reads the
snapshot, and only the refresh gathers the live sharded table."""
from __future__ import annotations

import dataclasses
import inspect
import time

import torch

from repro_torch.core import coherence, pres
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.models.modules import MemoryState
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.optimizers import apply_updates
from repro_torch.train import annotate
from repro_torch.train import capture as capture_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train import routing
from repro_torch.utils.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class PipelineState:
    """The embedding stage's read view of the memory table.

    `read_mem` / `read_last_update` are the snapshot; `pending` (N + 1,)
    counts per node the occurrences folded into the live table since the
    snapshot (the Eq. 7 "count" scale of the staleness fill), row N being
    the dump row of masked occurrences; `tick` counts the steps since the
    last refresh. The schedule does not depend on the data, so `tick` is a
    host int."""
    read_mem: torch.Tensor          # (N, D)
    read_last_update: torch.Tensor  # (N,)
    pending: torch.Tensor           # (N + 1,)
    tick: int = 0

    @staticmethod
    def init(mem: MemoryState) -> "PipelineState":
        """A snapshot of `mem` (copies: see the module docstring)."""
        return PipelineState(
            read_mem=mem.mem.detach().clone(),
            read_last_update=mem.last_update.detach().clone(),
            pending=torch.zeros(mem.mem.shape[0] + 1, dtype=torch.float32,
                                device=mem.mem.device))


PIPELINE_STATE_AXES = PipelineState(
    read_mem=("nodes", "embed"), read_last_update=("nodes",),
    pending=("nodes",), tick=())


def stale_read_table(cfg: MDGNNConfig, pres_state, pstate: PipelineState,
                     live_last_update=None):
    """The table the embedding stage reads: the snapshot rows extrapolated
    over their staleness gap by Eq. 7 over the whole (N, D) snapshot,
    through the `pres_predict` kernel with cfg.use_kernels, else the plain
    `pres.predict`. The scale follows cfg.pres_scale: "count" the pending
    count, "time" max(live_last_update - read_last_update, 0), where
    `live_last_update` is the live table's (only that scale reads it).
    Rows with nothing in flight have scale 0 and pass unchanged; without
    PRES the trackers are empty, the mixture mean is 0 and this is the raw
    snapshot. The mixture means are computed once on views of the tracker
    rows (`pres.mixture_mean_rows`: node i reads bucket i % pres_buckets
    with hashed trackers), not gathered per node."""
    n = pstate.read_mem.shape[0]
    if cfg.pres_scale == "time":
        if live_last_update is None:
            raise ValueError("pres_scale='time' needs the live last_update")
        scale = torch.clamp(live_last_update - pstate.read_last_update,
                            min=0.0)
    else:
        scale = pstate.pending[:n]
    # a bf16 snapshot is filled in fp32 and stored back in bf16, as JAX
    read = pstate.read_mem.float()
    if not cfg.use_kernels:
        filled = pres.predict(pres_state, read, scale, clip=cfg.pres_clip)
    else:
        dmean = pres.mixture_mean_rows(pres_state, n)
        filled = kops.pres_predict(read, dmean, scale, clip=cfg.pres_clip,
                                   mode=cfg.kernels_mode)
    return filled.to(pstate.read_mem.dtype)


def _count_pending(pending, nodes, mask, n: int) -> None:
    """pending[node] += 1 for every valid occurrence, IN PLACE (masked
    ones into the dump row n)."""
    keys = torch.where(mask, nodes, torch.full_like(nodes, n))
    pending.index_add_(0, keys, mask.to(torch.float32))


def make_pipelined_train_step(cfg: MDGNNConfig, opt, capture: bool = True):
    """The pipelined step (cfg.pipeline_depth >= 1; JAX
    `make_pipelined_train_step`, jitted with donated carries):
    train_step(params, opt_state, state, pstate, prev_batch, pos, neg) ->
    (params, opt_state, state, pstate, metrics).

    The lag-one step, except that the embedding reads the filled snapshot
    (`stale_read_table`) with the snapshot's last-update times. The
    metrics carry `staleness`, the batch-writes missing from the snapshot
    this step's embedding read (in [1, depth]). On CUDA the step replays
    a CUDA graph a batch shape (`PipelinedStep`); on the CPU, or with
    `capture=False`, it runs the body."""
    if cfg.pipeline_depth < 1:
        raise ValueError("make_pipelined_train_step needs pipeline_depth >= 1"
                         " - depth 0 is loop.make_train_step")
    use_smooth = (cfg.use_smoothing if cfg.use_smoothing is not None
                  else cfg.use_pres)
    if not (use_smooth and cfg.beta):
        raise ValueError(
            "pipeline_depth >= 1 without the coherence-smoothing term would "
            "freeze the memory/message parameters (the embedding reads a "
            "snapshot that is constant w.r.t. them, so Eq. 10 is the only "
            "gradient path); set use_smoothing=True with beta > 0 (the "
            "default when use_pres=True), or train with pipeline_depth=0")
    n = cfg.n_nodes
    sharded = cfg.n_shards > 1

    def body(params, opt_state, state, pstate, prev_batch: EventBatch,
             pos: EventBatch, neg: EventBatch, *, staleness: int):
        """The step up to the snapshot refresh, which does not touch the
        snapshot's tick: (params, opt_state, state, metrics)."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # MEMORY stage, on the live table
        with obs_trace.stage("memory_update"):
            mem2, info, fused, delta = loop_lib.memory_and_pres(
                params, cfg, state, prev_batch)
        state2 = dict(state, memory=mem2)
        # staleness accounting: this batch's occurrences are in flight
        mask = info["mask"]
        annotate.local(_count_pending, pstate.pending, info["nodes"], mask,
                       n, writes=(0,))
        # EMBEDDING stage, on the filled snapshot
        with obs_trace.stage("embed"):
            if sharded:
                dev = pstate.read_mem.device
                embed_base = routing.natural_state_view(
                    cfg, state2, dev, components=("neighbors", "mailbox"))
                pres_nat = routing.natural_component_view(
                    cfg, state["pres"], "pres", dev)
                live_lu = (routing.natural_rows(cfg, mem2.last_update, n, dev)
                           if cfg.pres_scale == "time" else None)
            else:
                embed_base, pres_nat = state2, state["pres"]
                live_lu = mem2.last_update
            read_tab = stale_read_table(cfg, pres_nat, pstate, live_lu)
            embed_state = dict(embed_base, memory=MemoryState(
                mem=read_tab, last_update=pstate.read_last_update))
            logit_p, logit_n = loop_lib.endpoint_logits(
                params, cfg, embed_state, pos, neg)
        with obs_trace.stage("loss"):
            loss = loop_lib.link_bce(logit_p, logit_n, pos.mask, neg.mask)
            pen = coherence.coherence_penalty(
                info["s_prev"], fused, mask=info["selected"] & mask)
            loss = loss + cfg.beta * pen
        obs = (loop_lib.obs_step_stats(params, cfg, info, fused.detach(),
                                       loss.detach(), pen.detach(), pos,
                                       staleness=staleness)
               if cfg.obs_metrics else None)
        with obs_trace.stage("apply"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            updates, opt_state = opt.update(tree_unflatten(params, grads),
                                            opt_state, params)
            apply_updates(params, updates)
        aux = {"delta": delta.detach(), "info_nodes": info["nodes"],
               "info_selected": info["selected"], "info_mask": mask}
        loop_lib.maintain_state(cfg, params, state2, aux, prev_batch)
        metrics = {"loss": loss.detach(), "coherence_penalty": pen.detach(),
                   "logit_p": logit_p.detach(), "logit_n": logit_n.detach()}
        metrics.update(loop_lib.route_metrics(cfg, info))
        if obs is not None:
            metrics["obs"] = obs
        return params, opt_state, state2, metrics

    return PipelinedStep(cfg, loop_lib.replicating_inputs(cfg, body,
                                                          n_carry=4),
                         capture)


def _advance(cfg: MDGNNConfig, state, pstate: PipelineState,
             staleness: int) -> None:
    """The snapshot's schedule after a step, in place: on the refresh
    step (`staleness` = depth) copies of the live table and its times,
    the pending counts zeroed and the tick reset; otherwise the tick
    advanced. The schedule does not depend on the data, so a captured
    step keeps this outside its graph: three copies on refresh steps."""
    if staleness >= cfg.pipeline_depth:
        live = (routing.natural_memory(cfg, state["memory"],
                                       pstate.read_mem.device)
                if cfg.n_shards > 1 else state["memory"])
        pstate.read_mem.copy_(live.mem)
        pstate.read_last_update.copy_(live.last_update)
        pstate.pending.zero_()
        pstate.tick = 0
    else:
        pstate.tick = staleness


class PipelinedStep(capture_lib.CapturedStep):
    """The pipelined step as train/capture.py runs it: the carry is the
    parameters, the optimizer state, the model state and the snapshot's
    three tensors; the graph is keyed by the batch shapes (and, with
    cfg.obs_metrics, by the staleness, a constant of the obs vector); the
    refresh follows the replay (`_advance`). `captured` / `eager_reason`
    say how the last call ran."""

    def __init__(self, cfg: MDGNNConfig, body, capture: bool = True):
        super().__init__(cfg, body, capture)
        self._snapshot: PipelineState | None = None

    def snapshot(self, mem: MemoryState) -> PipelineState:
        """A fresh snapshot of `mem` in this step's own buffers (made on
        the first call, or when `mem`'s shapes change), so that the
        graphs captured on them serve every epoch of a run."""
        own = self._snapshot
        if (own is None or own.read_mem.shape != mem.mem.shape
                or own.read_mem.dtype != mem.mem.dtype
                or own.read_mem.device != mem.mem.device):
            self._snapshot = PipelineState.init(mem)
            return self._snapshot
        with torch.no_grad():
            own.read_mem.copy_(mem.mem)
            own.read_last_update.copy_(mem.last_update)
            own.pending.zero_()
        own.tick = 0
        return own

    def __call__(self, params, opt_state, state, pstate, prev_batch, pos,
                 neg):
        staleness = pstate.tick + 1
        if self.eager(prev_batch.src.device, self.cfg, state):
            params, opt_state, state, metrics = self.body(
                params, opt_state, state, pstate, prev_batch, pos, neg,
                staleness=staleness)
        else:
            def fn(carry, inputs):
                *carry, metrics = self.body(*carry, *inputs,
                                            staleness=staleness)
                return carry, metrics

            key = ("pipelined", staleness if self.cfg.obs_metrics else None)
            metrics = self.run(key, fn, (params, opt_state, state, pstate),
                               (prev_batch, pos, neg))
        _advance(self.cfg, state, pstate, staleness)
        metrics["staleness"] = staleness
        return params, opt_state, state, pstate, metrics


def make_train_step(cfg: MDGNNConfig, opt, capture: bool = True):
    """The lag-one step at depth 0, the pipelined step otherwise."""
    if cfg.pipeline_depth == 0:
        return loop_lib.make_train_step(cfg, opt, capture)
    return make_pipelined_train_step(cfg, opt, capture)


def run_epoch(params, opt_state, state, batches, cfg: MDGNNConfig,
              train_step, generator, dst_range, negatives=None,
              collect_logits=False):
    """One epoch: `loop.run_epoch` at depth 0; otherwise the pipelined
    schedule from a fresh snapshot of the state's memory. `batches` may be
    a list or an iterator (`EventStream.prefetch_batches`, which is closed
    when the epoch ends or fails). A `PipelinedStep` keeps the snapshot in
    its own buffers from epoch to epoch (`PipelinedStep.snapshot`), so its
    graphs serve every epoch; a wrapper of one names it in `__wrapped__`.
    Negatives are drawn from `generator` unless `negatives` gives one
    batch per step. Losses and logits stay on the device until the epoch
    ends; `collect_logits` adds each step's AP (`EpochResult.aps`)."""
    if cfg.pipeline_depth == 0:
        return loop_lib.run_epoch(params, opt_state, state, batches, cfg,
                                  train_step, generator, dst_range,
                                  negatives=negatives,
                                  collect_logits=collect_logits)
    t0 = time.perf_counter()
    mem = state["memory"]
    if cfg.n_shards > 1:    # the snapshot lives in the natural layout
        mem = routing.natural_memory(cfg, mem)
    step = inspect.unwrap(train_step,
                          stop=lambda f: isinstance(f, PipelinedStep))
    pstate = (step.snapshot(mem) if isinstance(step, PipelinedStep)
              else PipelineState.init(mem))
    losses, pos_all, neg_all = [], [], []
    obs = obs_metrics.EpochObs()
    negs = None if negatives is None else iter(negatives)
    it = iter(batches)
    try:
        prev_batch = next(it)
        for batch in it:
            neg = loop_lib._negatives(negs, generator, batch, dst_range)
            params, opt_state, state, pstate, m = train_step(
                params, opt_state, state, pstate, prev_batch, batch, neg)
            losses.append(m["loss"])
            pos_all.append(m["logit_p"])
            neg_all.append(m["logit_n"])
            obs.step(m)
            prev_batch = batch
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    return params, opt_state, state, loop_lib.epoch_result(
        losses, pos_all, neg_all, t0, collect_logits, obs)
