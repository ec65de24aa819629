"""Memory maintenance shared by training and serving, serve subset
(counterpart of `repro/train/loop.py`: `_pres_scale_and_ids`,
`_fused_memory_update`, `memory_and_pres` (fused branch) and
`maintain_state`). Training itself is a later slice (ROADMAP Queue 1
item 9).

All state updates are IN PLACE on the state dict's tensors, where the JAX
engine donates and aliases its buffers."""
from __future__ import annotations

import torch

from repro_torch.core import batching, pres
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig


def _pres_scale_and_ids(cfg: MDGNNConfig, info):
    """Eq. 7 extrapolation scale ("count": the node's valid-occurrence
    count in the batch) and the tracker ids of the occurrences."""
    nodes, mask = info["nodes"], info["mask"]
    keys = torch.where(mask, nodes, torch.full_like(nodes, cfg.n_nodes))
    counts = torch.zeros(cfg.n_nodes + 1, dtype=torch.float32,
                         device=nodes.device)
    counts.index_add_(0, keys, mask.to(torch.float32))
    return counts[nodes], nodes


def _fused_memory_update(params, cfg: MDGNNConfig, state, batch: EventBatch):
    """The memory-maintenance step as ONE `memory_update_table` call over
    the touched rows (GRU gates, Eq. 7 predict, Eq. 8 correct, Eq. 9 delta
    and the table/timestamp scatter), in place on state["memory"]. Only the
    GMM mixture-mean gather stays outside.

    Occurrences go to the kernel in mdgnn.occurrence_order (its two-phase
    design does not need that order, but the plain version and the JAX
    kernel see the same layout) and the (M, D) outputs are permuted back to
    batch order. Returns (info, fused, delta)."""
    mem = state["memory"]
    nodes, times, msgs, mask, selected = mdgnn.memory_inputs(
        params, cfg, mem, batch)
    info = {"nodes": nodes, "selected": selected, "mask": mask,
            "t_now": times, "msgs": msgs}
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
    _, _, s_meas, fused, delta = kops.memory_update_table(
        mem.mem, mem.last_update, msgs[order].contiguous(),
        gidx.to(torch.int32), widx.to(torch.int32), times[order],
        params["mem"]["w"], params["mem"]["u"], params["mem"]["b"],
        dmean[order].contiguous(), scale[order], gamma,
        clip=cfg.pres_clip, delta_mode=cfg.delta_mode, mode=cfg.kernels_mode)
    info["s_meas"] = s_meas[inv]
    return info, fused[inv], delta[inv]


def memory_and_pres(params, cfg: MDGNNConfig, state, batch: EventBatch):
    """MEMORY stage + PRES fusion (the fused-kernel branch, the only one the
    supported configuration takes). Returns (info, fused_rows, deltas)."""
    mdgnn.check_supported(cfg)
    return _fused_memory_update(params, cfg, state, batch)


def maintain_state(cfg: MDGNNConfig, state, aux, batch: EventBatch,
                   track_deltas: bool = True) -> None:
    """Post-fold state maintenance, in place: the PRES tracker update (when
    `track_deltas`; the JAX engine masks `use_pres` for the same effect) and
    the neighbour-ring append."""
    if track_deltas:
        nodes = aux["info_nodes"]
        pres.update_trackers(state["pres"], nodes, aux["delta"],
                             torch.zeros_like(nodes),
                             aux["info_selected"] & aux["info_mask"])
    batching.update_neighbors(state["neighbors"], batch)
