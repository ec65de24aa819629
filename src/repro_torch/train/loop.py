"""MDGNN training loop, lag-one (counterpart of `repro/train/loop.py`):
Alg. 1 (standard) and Alg. 2 (PRES). Temporal batch B_{i-1} updates the
memory, then the embeddings predict batch B_i against sampled negatives.
With PRES the memory measurement is fused with the GMM prediction and the
coherence smoothing term (Eq. 10) joins the loss. The memory maintenance
here (`memory_and_pres`, `maintain_state`) is shared with serving.

Kernel routing (cfg.use_kernels): PRES with the GRU cell runs the whole
memory step as one `memory_update_table` call; otherwise the memory cell
runs on its own (the `gru_cell` kernel, or the plain rnn cell) and, with
PRES, the `pres_filter` kernel fuses its rows with the prediction; every
layer of the deduplicated TGN embedding is `embed_attn`, and the attention
of the dense TGN path and of APAN is `neighbor_attn`. Each is
differentiable (kernels/autodiff.py): the kernel forward, a backward
through its plain version. Without cfg.use_kernels the step is the
reference's plain route, which launches no kernel: the plain cell, then
`pres.predict` and `pres.correct`, the plain attention. The pipelined
schedule (`pipeline_depth >= 1`) is `train/pipeline.py`; it shares the
memory stage and the state maintenance here.

State updates are IN PLACE on the state dict's tensors where the JAX
engine donates and aliases its buffers, and the state is detached after
every step (the JAX step's stop_gradient)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import batching, coherence, pres
from repro_torch.graph.events import EventBatch
from repro_torch.graph.negatives import sample_negatives
from repro_torch.kernels import autodiff
from repro_torch.kernels import ops as kops
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.models.modules import MemoryState
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils import metrics as metrics_lib
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _pres_scale_and_ids(cfg: MDGNNConfig, info):
    """Eq. 7 extrapolation scale and the tracker ids of the occurrences.
    "count": the node's valid-occurrence count in the batch; "time" (the
    paper's t2 - t1): max(t_now - t_prev, 0), t_prev read before the
    memory stage wrote `last_update`. The ids are the nodes, or with
    hashed trackers (Sec. 5.3) their buckets, node % pres_buckets."""
    nodes, mask = info["nodes"], info["mask"]
    ids = nodes % cfg.pres_buckets if cfg.pres_buckets else nodes
    if cfg.pres_scale == "time":
        return torch.clamp(info["t_now"] - info["t_prev"], min=0.0), ids
    keys = torch.where(mask, nodes, torch.full_like(nodes, cfg.n_nodes))
    counts = torch.zeros(cfg.n_nodes + 1, dtype=torch.float32,
                         device=nodes.device)
    counts.index_add_(0, keys, mask.to(torch.float32))
    return counts[nodes], ids


def _apply_pres(params, cfg: MDGNNConfig, mem, info, pres_state):
    """Fuse the measured rows of the cell route with the GMM prediction
    (Eq. 7 -> 8 -> 9) and write each node's fused row of its selected
    occurrence into the table, IN PLACE on `mem` (autograd records the
    write). With cfg.use_kernels the `pres_filter` kernel; without, the
    reference's plain chain: `pres.predict`, `pres.correct`, then the
    delta rate by cfg.delta_mode, per unit of the scale. Returns (mem,
    fused, delta)."""
    scale, pres_ids = _pres_scale_and_ids(cfg, info)
    if cfg.use_kernels:
        dmean = pres.mixture_mean(pres_state, pres_ids)
        gamma = torch.sigmoid(params["pres"]["gamma_logit"])
        fused, delta = kops.pres_filter(
            info["s_prev"], info["s_meas"], dmean, scale, gamma,
            clip=cfg.pres_clip, delta_mode=cfg.delta_mode,
            mode=cfg.kernels_mode)
    else:
        s_pred = pres.predict(pres_state, info["s_prev"], scale, pres_ids,
                              clip=cfg.pres_clip)
        fused = pres.correct(params["pres"], s_pred, info["s_meas"])
        base = s_pred if cfg.delta_mode == "innovation" else info["s_prev"]
        delta = (fused - base) / torch.clamp(scale, min=1.0)[:, None]
    keep = info["written"]
    mem.mem[info["nodes"].index_select(0, keep)] = fused.index_select(0, keep)
    return mem, fused, delta


def _fused_memory_update(params, cfg: MDGNNConfig, state, batch: EventBatch):
    """The memory-maintenance step as ONE `memory_update_table` call over
    the touched rows (GRU gates, Eq. 7 predict, Eq. 8 correct, Eq. 9 delta
    and the table/timestamp scatter), in place on state["memory"]. Only the
    GMM mixture-mean gather stays outside.

    Occurrences go to the kernel in mdgnn.occurrence_order (its two-phase
    design does not need that order, but the plain version and the JAX
    kernel see the same layout) and the (M, D) outputs are permuted back to
    batch order. Returns (mem, info, fused, delta); mem holds the tensors
    the kernel returned, which carry the gradient of the written rows.
    When autograd records (the train step), info["s_prev"] holds the rows
    before the write (zeros where masked), the same rows the kernel's
    Function saves for its backward."""
    mem = state["memory"]
    nodes, times, msgs, mask, selected = mdgnn.memory_inputs(params, cfg,
                                                             mem, batch)
    # the "time" scale's t_prev before the kernel writes last_update in place
    t_prev = mem.last_update[nodes] if cfg.pres_scale == "time" else None
    info = {"nodes": nodes, "selected": selected, "mask": mask,
            "t_prev": t_prev, "t_now": times, "msgs": msgs}
    scale, pres_ids = _pres_scale_and_ids(cfg, info)
    dmean = pres.mixture_mean(state["pres"], pres_ids)
    gamma = torch.sigmoid(params["pres"]["gamma_logit"])
    order = mdgnn.occurrence_order(nodes, times, mask)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    n = cfg.n_nodes
    # index N = masked-write dump, N + 1 = zeros masked-read source
    gidx = torch.where(mask, nodes, torch.full_like(nodes, n + 1))[order]
    widx = torch.where(selected, nodes, torch.full_like(nodes, n))[order]
    h = None
    if torch.is_grad_enabled():
        h = autodiff.gather_rows(mem.mem, gidx)
        info["s_prev"] = h[inv]
    table, last_t, s_meas, fused, delta = kops.memory_update_table(
        mem.mem, mem.last_update, msgs[order].contiguous(),
        gidx.to(torch.int32), widx.to(torch.int32), times[order],
        params["mem"]["w"], params["mem"]["u"], params["mem"]["b"],
        dmean[order].contiguous(), scale[order], gamma,
        clip=cfg.pres_clip, delta_mode=cfg.delta_mode, mode=cfg.kernels_mode,
        h=h)
    info["s_meas"] = s_meas[inv]
    return MemoryState(mem=table, last_update=last_t), info, fused[inv], \
        delta[inv]


def memory_and_pres(params, cfg: MDGNNConfig, state, batch: EventBatch):
    """MEMORY stage + PRES fusion, shared by the train, eval and serve
    steps. With cfg.use_kernels, PRES and the GRU cell: the fused
    `memory_update_table` pass. Otherwise the cell-based
    `mdgnn.memory_update` and, with PRES, `_apply_pres`, the cell's rows
    left unwritten; without PRES the fused rows are the measurements and
    the deltas are zero. Returns (mem, info, fused_rows, deltas)."""
    mdgnn.check_supported(cfg)
    if cfg.use_kernels and cfg.use_pres and cfg.memory_cell == "gru":
        return _fused_memory_update(params, cfg, state, batch)
    mem2, info = mdgnn.memory_update(params, cfg, state["memory"], batch,
                                     defer_write=cfg.use_pres)
    if cfg.use_pres:
        mem2, fused, delta = _apply_pres(params, cfg, mem2, info,
                                         state["pres"])
        return mem2, info, fused, delta
    fused = info["s_meas"]
    return mem2, info, fused, torch.zeros_like(fused)


def endpoint_logits(params, cfg: MDGNNConfig, state2, pos: EventBatch,
                    neg: EventBatch):
    """Link logits of a positive and a negative batch, from ONE embedding
    call over the four endpoint sets."""
    h = mdgnn.embed_nodes(params, cfg, state2,
                          torch.cat([pos.src, pos.dst, neg.src, neg.dst]),
                          torch.cat([pos.t, pos.t, neg.t, neg.t]))
    b = pos.src.shape[0]
    logit_p = mdgnn.link_logits(params, h[:b], h[b:2 * b])
    logit_n = mdgnn.link_logits(params, h[2 * b:3 * b], h[3 * b:])
    return logit_p, logit_n


def link_bce(logit_p, logit_n, pos_mask, neg_mask):
    """Masked mean binary cross-entropy over positive/negative logits."""
    bce_p = torch.sum(F.softplus(-logit_p) * pos_mask)
    bce_n = torch.sum(F.softplus(logit_n) * neg_mask)
    denom = torch.clamp(pos_mask.sum() + neg_mask.sum(), min=1.0)
    return (bce_p + bce_n) / denom


def update_mailbox(params, cfg: MDGNNConfig, state,
                   batch: EventBatch) -> None:
    """APAN: the batch's messages, recomputed from the memory as it stands
    after the step (with the parameters as they stand), appended to the
    mailboxes in place. No gradient reaches the mailbox."""
    with torch.no_grad():
        nodes, times, msgs, mask = mdgnn.compute_messages(
            params, cfg, state["memory"], batch)
        mdgnn.update_mailbox(state["mailbox"], nodes, msgs, times, mask)


def maintain_state(cfg: MDGNNConfig, params, state, aux, batch: EventBatch,
                   track_deltas: bool = True) -> None:
    """Post-step state maintenance, in place: detach the memory (the JAX
    step's stop_gradient), update the PRES trackers (with PRES and
    `track_deltas`; at node % pres_buckets with hashed trackers), append
    the batch to the neighbour rings and, for APAN, its messages to the
    mailboxes."""
    state["memory"].mem.detach_()
    state["memory"].last_update.detach_()
    if track_deltas and cfg.use_pres:
        nodes = aux["info_nodes"]
        ids = nodes % cfg.pres_buckets if cfg.pres_buckets else nodes
        pres.update_trackers(state["pres"], ids, aux["delta"],
                             torch.zeros_like(nodes),
                             aux["info_selected"] & aux["info_mask"])
    batching.update_neighbors(state["neighbors"], batch)
    if cfg.variant == "apan":
        update_mailbox(params, cfg, state, batch)


def make_train_step(cfg: MDGNNConfig, opt):
    """The lag-one train step (JAX `make_step_body` / `make_train_step`):
    train_step(params, opt_state, state, prev_batch, pos, neg) ->
    (params, opt_state, state, metrics).

    The loss is differentiated with torch.autograd with respect to every
    parameter (zeros for the ones it does not reach, as jax.grad gives).
    Parameters and the optimizer state are updated in place, and so is the
    state: the caller keeps using the returned objects, as the JAX caller
    of its donated step does."""
    use_smooth = (cfg.use_smoothing if cfg.use_smoothing is not None
                  else cfg.use_pres)

    def train_step(params, opt_state, state, prev_batch, pos, neg):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        mem2, info, fused, delta = memory_and_pres(params, cfg, state,
                                                   prev_batch)
        state2 = dict(state, memory=mem2)
        logit_p, logit_n = endpoint_logits(params, cfg, state2, pos, neg)
        loss = link_bce(logit_p, logit_n, pos.mask, neg.mask)
        pen = coherence.coherence_penalty(
            info["s_prev"], fused, mask=info["selected"] & info["mask"])
        if use_smooth and cfg.beta:
            loss = loss + cfg.beta * pen
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        updates, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
        apply_updates(params, updates)
        aux = {"delta": delta.detach(), "info_nodes": info["nodes"],
               "info_selected": info["selected"], "info_mask": info["mask"]}
        maintain_state(cfg, params, state2, aux, prev_batch)
        metrics = {"loss": loss.detach(), "coherence_penalty": pen.detach(),
                   "logit_p": logit_p.detach(), "logit_n": logit_n.detach()}
        return params, opt_state, state2, metrics

    return train_step


def make_eval_step(cfg: MDGNNConfig):
    """eval_step(params, state, prev_batch, pos, neg) -> (state, logit_p,
    logit_n): the memory update, the neighbour rings and APAN's mailbox,
    in place, then the logits. The PRES trackers are not updated, as in
    the JAX eval step."""

    @torch.no_grad()
    def eval_step(params, state, prev_batch, pos, neg):
        mem2, _, _, _ = memory_and_pres(params, cfg, state, prev_batch)
        state2 = dict(state, memory=mem2)
        batching.update_neighbors(state2["neighbors"], prev_batch)
        if cfg.variant == "apan":
            update_mailbox(params, cfg, state2, prev_batch)
        logit_p, logit_n = endpoint_logits(params, cfg, state2, pos, neg)
        return state2, logit_p, logit_n

    return eval_step


@dataclasses.dataclass
class EpochResult:
    ap: float
    loss: float
    seconds: float
    # with run_epoch(collect_logits=True): the AP of each step's logits
    aps: list = dataclasses.field(default_factory=list)


def _negatives(negatives, generator, batch, dst_range):
    if negatives is None:
        return sample_negatives(generator, batch, *dst_range)
    try:
        return next(negatives)
    except StopIteration:
        raise ValueError("fewer injected negative batches than steps") \
            from None


def _logits_ap(pos_all, neg_all):
    """AP over the concatenated logits (padding rows included, as the JAX
    loop does), fetched in one copy."""
    pos = torch.cat(pos_all).cpu().numpy()
    neg = torch.cat(neg_all).cpu().numpy()
    return pos, neg, metrics_lib.average_precision(pos, neg)


def epoch_result(losses, pos_all, neg_all, seconds_from, collect_logits):
    """The EpochResult of an epoch's device losses and logits, fetched in
    one copy each; with `collect_logits` the AP of every step too (from
    the same copy, split by step)."""
    loss = float(np.mean(torch.stack(losses).double().cpu().numpy()))
    pos, neg, ap = _logits_ap(pos_all, neg_all)
    aps = []
    if collect_logits:
        cut = lambda a, parts: np.split(a, np.cumsum(
            [p.shape[0] for p in parts])[:-1])
        aps = [metrics_lib.average_precision(p, n) for p, n in
               zip(cut(pos, pos_all), cut(neg, neg_all))]
    return EpochResult(ap, loss, time.perf_counter() - seconds_from, aps)


def run_epoch(params, opt_state, state, batches, cfg: MDGNNConfig,
              train_step, generator, dst_range, negatives=None,
              collect_logits=False):
    """One training epoch over the temporal batches (lag-one).

    Negatives are drawn from `generator` unless `negatives` gives one
    batch per step (the parity tests inject the JAX package's draws).
    Losses and logits stay on the device until the epoch ends, so the loop
    itself does not wait for the device; `collect_logits` adds each
    step's AP (`EpochResult.aps`), computed from the same end-of-epoch
    copy."""
    t0 = time.perf_counter()
    losses, pos_all, neg_all = [], [], []
    negs = None if negatives is None else iter(negatives)
    it = iter(batches)
    prev_batch = next(it)
    for batch in it:
        neg = _negatives(negs, generator, batch, dst_range)
        params, opt_state, state, m = train_step(params, opt_state, state,
                                                 prev_batch, batch, neg)
        losses.append(m["loss"])
        pos_all.append(m["logit_p"])
        neg_all.append(m["logit_n"])
        prev_batch = batch
    return params, opt_state, state, epoch_result(
        losses, pos_all, neg_all, t0, collect_logits)


def evaluate(params, state, batches, cfg: MDGNNConfig, eval_step, generator,
             dst_range, negatives=None):
    """Evaluation pass on a copy of `state` (the caller's state is left as
    it was, as with the JAX version's functional state). Returns
    (final eval state, AP, AUC). A split of one batch scores no pair (the
    lag-one pass folds it and stops): AP and AUC are then nan, where the
    JAX version raises (a short csv's validation split)."""
    state = mdgnn.clone_state(state)
    pos_all, neg_all = [], []
    negs = None if negatives is None else iter(negatives)
    it = iter(batches)
    prev_batch = next(it)
    for batch in it:
        neg = _negatives(negs, generator, batch, dst_range)
        state, lp, ln = eval_step(params, state, prev_batch, batch, neg)
        pos_all.append(lp)
        neg_all.append(ln)
        prev_batch = batch
    if not pos_all:
        return state, float("nan"), float("nan")
    pos, neg, ap = _logits_ap(pos_all, neg_all)
    return state, ap, metrics_lib.roc_auc(pos, neg)
