"""TGN temporal-attention embedding on the deduplicated frontier
(counterpart of `repro/models/embeddings.py`: `tgn_apply`,
`_tgn_apply_dedup`, `_tgn_layer_compact`). Each layer's attention runs
through the `embed_attn` kernel (`kernels/ops.py`), whose plain version is
the CPU route; the output projection `wo` is a plain matrix product."""
from __future__ import annotations

import torch

from repro_torch.core import batching
from repro_torch.kernels import ops as kops


def _tgn_layer_compact(params, layer_params, h_self, h_child, t_self, child,
                       cfg):
    """One attention layer: rows of h_self attend over their K neighbours'
    layer l-1 rows in the child hop's unique table."""
    rows = h_self.shape[0]
    kk = child["valid"].shape[1]
    dt = t_self[:, None] - child["t_edge"]
    agg = kops.embed_attn(
        h_self, h_child,
        child["inverse"].reshape(rows, kk).to(torch.int32), dt,
        child["valid"], params["time"]["w"], params["time"]["b"],
        layer_params["wq"], layer_params["wk"], layer_params["wv"],
        n_heads=cfg.n_heads, mode=cfg.kernels_mode)
    return torch.relu(torch.cat([agg, h_self], dim=-1) @ layer_params["wo"])


def _tgn_apply_dedup(params, cfg, state, nodes, t_query):
    """Hop 0 (the seeds) stays uncompacted; hop d >= 1 holds one row per
    distinct (node, time) key, computed once per layer."""
    mem = state["memory"]
    n_layers = cfg.n_layers
    hops = batching.expand_frontiers_unique(state["neighbors"], nodes,
                                            t_query, n_layers, cfg.n_nodes)
    h = [mem.mem[hop["nodes"]] for hop in hops]
    for l in range(1, n_layers + 1):
        lp = params["emb"][f"l{l - 1}"]
        h = [_tgn_layer_compact(params, lp, h[d], h[d + 1], hops[d]["t"],
                                hops[d + 1], cfg)
             for d in range(n_layers - l + 1)]
    return h[0]


def tgn_apply(params, cfg, state, nodes, t_query):
    """L-hop temporal graph attention (the dedup path; cfg.dedup_embed is
    required by mdgnn.check_supported)."""
    return _tgn_apply_dedup(params, cfg, state, nodes, t_query)
