"""Temporal batching machinery (counterpart of `repro/core/batching.py`):
the pending-set probes of Defs. 1-2, per-endpoint occurrences, the
per-node last-message and mean reductions, the neighbour ring buffers
(shared with APAN's mailbox), the k-hop frontier expansions of the
embedding path (the deduplicated one and the dense one) and the dedup
probe of the benchmarks.

Neighbour state layout: `nbr` (N + 1, K) int32 (-1 = empty slot), `t`
(N + 1, K) float32 and `ptr` (N + 1,) int32, where row N is a dump row for
masked or superseded ring writes; the state proper is rows [:N]. All
updates are dense scatters with no data-dependent shapes."""
from __future__ import annotations

import math

import torch

from repro_torch.graph.events import EventBatch

INT32_MAX = 2 ** 31 - 1


def lexsort(keys):
    """Indices sorting by `keys`, the LAST key primary (numpy/jnp lexsort
    order): one stable sort per key, least significant first, so ties keep
    their original order."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        perm = torch.sort(kk, stable=True).indices
        order = perm if order is None else order[perm]
    return order


def pending_counts(src, dst, t, mask=None):
    """|P(e, B)| for every event e of a batch (Defs. 1-2): the number of
    earlier events in the batch that share a vertex with it, (b,) int64.
    O(b^2): an analysis probe, not a training-path op."""
    share = ((src[:, None] == src[None, :]) | (src[:, None] == dst[None, :])
             | (dst[:, None] == src[None, :])
             | (dst[:, None] == dst[None, :]))
    pend = share & (t[None, :] < t[:, None])
    if mask is not None:
        pend = pend & mask[None, :] & mask[:, None]
    return pend.sum(dim=1)


def pending_fraction(batch: EventBatch) -> float:
    """Fraction of the batch's valid events with a non-empty pending set,
    which grows with the batch size (the knob behind Theorem 2)."""
    cnt = pending_counts(batch.src, batch.dst, batch.t, batch.mask)
    valid = batch.mask.sum()
    return float(((cnt > 0) & batch.mask).sum() / torch.clamp(valid, min=1))


def node_occurrences(batch: EventBatch):
    """Per-endpoint occurrences in [all srcs, all dsts] order:
    (nodes, times, other, feat, mask), each of length 2b."""
    nodes = torch.cat([batch.src, batch.dst])
    other = torch.cat([batch.dst, batch.src])
    times = torch.cat([batch.t, batch.t])
    feat = torch.cat([batch.feat, batch.feat], dim=0)
    mask = torch.cat([batch.mask, batch.mask])
    return nodes, times, other, feat, mask


def last_per_node(nodes, times, values, mask, num_nodes: int):
    """The chronologically last valid value of each node (TGN's
    aggregator): ((N, D) values, (N,) times, (N,) touched flags). Sorted by
    (node, time) with masked rows first in their node's run, the last row
    of each run is taken if valid; the others write a dump row."""
    big = torch.where(mask, times, torch.full_like(times, -math.inf))
    order = lexsort((big, nodes))
    n_sorted = nodes[order]
    is_last = torch.ones_like(n_sorted, dtype=torch.bool)
    is_last[:-1] = n_sorted[1:] != n_sorted[:-1]
    take = is_last & mask[order]
    idx = torch.where(take, n_sorted, torch.full_like(n_sorted, num_nodes))
    out = torch.zeros((num_nodes + 1, values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    out[idx] = values[order]
    t_out = torch.zeros(num_nodes + 1, dtype=times.dtype, device=times.device)
    t_out[idx] = times[order]
    touched = torch.zeros(num_nodes + 1, dtype=torch.bool,
                          device=nodes.device)
    touched[idx] = True
    return out[:num_nodes], t_out[:num_nodes], touched[:num_nodes]


def mean_per_node(nodes, values, mask, num_nodes: int):
    """Mean of the valid rows of `values` per node: ((N, D) means, (N,)
    touched flags). Masked rows sum into a dump row. Differentiable (an
    out-of-place index_add); on CUDA its sums run in atomic order, so they
    agree with a sequential sum to rounding, not bits."""
    idx = torch.where(mask, nodes, torch.full_like(nodes, num_nodes))
    m = mask.to(values.dtype)
    zeros = torch.zeros((num_nodes + 1, values.shape[-1]),
                        dtype=values.dtype, device=values.device)
    summed = zeros.index_add(0, idx, values * m[:, None])
    cnt = torch.zeros(num_nodes + 1, dtype=values.dtype,
                      device=values.device).index_add(0, idx, m)
    mean = summed / torch.clamp(cnt[:, None], min=1.0)
    return mean[:num_nodes], cnt[:num_nodes] > 0


def init_neighbors(n_nodes: int, k: int, device):
    """Empty ring buffers with the trailing dump row."""
    return {
        "nbr": torch.full((n_nodes + 1, k), -1, dtype=torch.int32,
                          device=device),
        "t": torch.zeros((n_nodes + 1, k), dtype=torch.float32, device=device),
        "ptr": torch.zeros((n_nodes + 1,), dtype=torch.int32, device=device),
    }


def ring_buffer_append(buffers, ptr, nodes, values, mask) -> None:
    """Append per-occurrence rows to per-node ring buffers, IN PLACE.

    buffers: name -> (N + 1, K, ...) rings sharing the (N + 1,) pointer
    `ptr`; nodes (M,) int64; values: name -> (M, ...); mask (M,) bool.
    Same-node occurrences land in consecutive slots in array order. When a
    node has more than K occurrences in one call only its last K are
    written: that is the sequential meaning, and it keeps every write slot
    unique (duplicate indices in a CUDA index_put_ land in no fixed order).
    Masked and superseded rows write to the dump row N."""
    n = ptr.shape[0] - 1
    k = next(iter(buffers.values())).shape[1]
    m = nodes.shape[0]
    keys = torch.where(mask, nodes, torch.full_like(nodes, n))
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order]
    pos = torch.arange(m, device=nodes.device)
    starts = torch.ones(m, dtype=torch.bool, device=nodes.device)
    starts[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(starts, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    counts = torch.zeros(n + 1, dtype=torch.int64, device=nodes.device)
    counts.index_add_(0, keys, torch.ones_like(keys))
    keep = mask & (rank >= counts[keys] - k)
    slot = (ptr[nodes].long() + rank) % k
    flat = torch.where(keep, nodes * k + slot, torch.full_like(nodes, n * k))
    for name, buf in buffers.items():
        fb = buf.view((-1,) + tuple(buf.shape[2:]))
        fb[flat] = values[name].to(buf.dtype)
    ptr.copy_((ptr.long() + counts) % k)


def update_neighbors(state, batch: EventBatch) -> None:
    """Append each event's endpoints to each other's rings, IN PLACE."""
    nodes, times, other, _, mask = node_occurrences(batch)
    ring_buffer_append({"nbr": state["nbr"], "t": state["t"]}, state["ptr"],
                       nodes, {"nbr": other, "t": times}, mask)


def gather_frontier(neighbors, nodes):
    """One-hop temporal neighbourhood of `nodes`: (nbr (M, K) int64 with -1
    for empty slots, t (M, K) float32 edge times, valid (M, K) bool)."""
    nbr = neighbors["nbr"][nodes].long()
    return nbr, neighbors["t"][nodes], nbr >= 0


def compact_unique(nodes, t, budget: int):
    """Static-shape segment-unique over (node, time) keys.

    Returns {"nodes" (budget,) unique ids (slots >= n_unique hold 0),
    "t" (budget,), "inverse" (n,) int64 with uniq[inverse] == input,
    "n_unique" () int64}. `budget` must bound the distinct-key count."""
    n = nodes.shape[0]
    budget = int(min(budget, n))
    order = lexsort((t, nodes))
    ns, ts = nodes[order], t[order]
    new = torch.ones(n, dtype=torch.bool, device=nodes.device)
    new[1:] = (ns[1:] != ns[:-1]) | (ts[1:] != ts[:-1])
    slot = torch.cumsum(new.long(), 0) - 1
    # slots past the budget would be dropped (never, for a sound budget):
    # they go to an extra row that is sliced off. Every key of a run writes
    # the same value, so repeated slot indices are harmless.
    dst = torch.clamp(slot, max=budget)
    uniq_nodes = torch.zeros(budget + 1, dtype=nodes.dtype,
                             device=nodes.device)
    uniq_nodes[dst] = ns
    uniq_t = torch.zeros(budget + 1, dtype=t.dtype, device=t.device)
    uniq_t[dst] = ts
    inverse = torch.empty(n, dtype=torch.int64, device=nodes.device)
    inverse[order] = slot
    return {"nodes": uniq_nodes[:budget], "t": uniq_t[:budget],
            "inverse": inverse, "n_unique": slot[-1] + 1}


def expand_frontiers_unique(neighbors, nodes, t_query, n_hops: int,
                            n_nodes: int):
    """Deduplicated k-hop expansion: hop 0 is the seeds, uncompacted; hop
    d >= 1 is compact_unique over the expansion of hop d-1 under the budget
    min(rows_{d-1}, n_nodes) * K, plus "valid" and "t_edge" (rows_{d-1}, K)
    at parent granularity."""
    hops = [{"nodes": nodes, "t": t_query}]
    for _ in range(n_hops):
        prev_rows = hops[-1]["nodes"].shape[0]
        nbr, t, valid = gather_frontier(neighbors, hops[-1]["nodes"])
        kk = nbr.shape[1]
        budget = min(prev_rows, n_nodes) * kk
        hop = compact_unique(torch.clamp(nbr, min=0).reshape(-1),
                             t.reshape(-1), budget)
        hop["valid"] = valid
        hop["t_edge"] = t
        hops.append(hop)
    return hops


def expand_frontiers(neighbors, nodes, t_query, n_hops: int):
    """The dense k-hop expansion with static (M * K**d,) shapes (the
    `dedup_embed=False` path): hop 0 is {"nodes" (M,), "t" (M,)}; hop d
    >= 1 is {"nodes" (M * K**d,) with empty slots clamped to node 0, "t"
    (M * K**d,) the ring's edge times, "valid" (M * K**(d-1), K)}."""
    hops = [{"nodes": nodes, "t": t_query}]
    for _ in range(n_hops):
        nbr, t, valid = gather_frontier(neighbors, hops[-1]["nodes"])
        hops.append({"nodes": torch.clamp(nbr, min=0).reshape(-1),
                     "t": t.reshape(-1), "valid": valid})
    return hops


def frontier_dedup_stats(neighbors, nodes, t_query, n_hops: int,
                         n_nodes: int) -> dict:
    """Dedup probe for benchmark metadata: per hop the raw expansion size,
    the static unique budget and the distinct (node, time) keys found.
    Ratios below 1 mean the deduplicated path does less work. A host-side
    probe: it reads the distinct counts back to the host (a device wait
    each), so no serve or train body calls it."""
    hops = expand_frontiers_unique(neighbors, nodes, t_query, n_hops, n_nodes)
    raw = [int(h["inverse"].shape[0]) for h in hops[1:]]
    budget = [int(h["nodes"].shape[0]) for h in hops[1:]]
    uniq = [int(h["n_unique"]) for h in hops[1:]]
    tot = max(sum(raw), 1)
    return {"raw_rows": raw, "budget_rows": budget, "unique_rows": uniq,
            "budget_ratio": sum(budget) / tot,
            "measured_ratio": sum(uniq) / tot}
