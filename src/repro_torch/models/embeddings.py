"""EMBEDDING modules (counterpart of `repro/models/embeddings.py`):

    tgn_attn      L-hop temporal graph attention over the neighbour rings.
                  With cfg.dedup_embed (the default) each hop is compacted
                  to its distinct (node, time) keys and every layer runs
                  through the `embed_attn` kernel (`_tgn_apply_dedup`);
                  without it the static (M * K**d) expansion runs each
                  layer's attention through `neighbor_attn`
                  (`_tgn_apply_dense`).
    jodie_proj    JODIE's time projection h = tanh(((1 + dt w) . s) W)
                  with cfg.n_layers - 1 more tanh layers; no kernel, as in
                  the reference.
    apan_mailbox  stacked attention of the node's memory row over its
                  mailbox of propagated messages, through `neighbor_attn`.

Without cfg.use_kernels every attention is the reference's plain route:
the single-head masked attention of `ref.neighbor_attn_ref` with the heads
folded into the rows, and the deduplicated layer as a gather from the
unique table, the time encoding and Q/K/V products before it. The output
projection `wo` of every layer is a plain matrix product."""
from __future__ import annotations

import torch

from repro_torch.core import batching
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import modules
from repro_torch.train import annotate


def neighbor_attention(q, k, v, valid, cfg):
    """Multi-head masked attention, the heads folded into the rows: (M, E)
    -> (M * H, E / H), so one single-head loop runs them all: the
    `neighbor_attn` kernel with cfg.use_kernels, else the plain
    `ref.neighbor_attn_ref`. At H = 1 the folds are identities. q: (M, E);
    k, v: (M, K, E); valid: (M, K) bool."""
    m, e = q.shape
    kk = k.shape[1]
    h = cfg.n_heads
    if h > 1:
        dh = e // h
        q = q.reshape(m * h, dh)
        k = k.reshape(m, kk, h, dh).transpose(1, 2).reshape(m * h, kk, dh)
        v = v.reshape(m, kk, h, dh).transpose(1, 2).reshape(m * h, kk, dh)
        valid = torch.repeat_interleave(valid, h, dim=0)
    if cfg.use_kernels:
        agg = kops.neighbor_attn(q, k, v, valid, mode=cfg.kernels_mode)
    else:
        agg = ref.neighbor_attn_ref(q, k, v, valid)
    if h > 1:
        agg = agg.reshape(m, e)
    return agg


def _tgn_layer(params, layer_params, h_self, h_nbr, t_self, t_nbr, valid,
               cfg):
    """One dense attention layer: rows of h_self attend over their K
    neighbours' layer l-1 rows h_nbr (M * K, d), keyed by [h_nbr,
    cos(dt * w + b)]."""
    m = h_self.shape[0]
    kk = valid.shape[1]
    dt = t_self[:, None] - t_nbr.reshape(m, kk)
    t_enc = modules.time_encode(params["time"], dt)
    kv_in = torch.cat([h_nbr.reshape(m, kk, -1), t_enc], dim=-1)
    q = h_self @ layer_params["wq"]
    k = kv_in @ layer_params["wk"]
    v = kv_in @ layer_params["wv"]
    agg = neighbor_attention(q, k, v, valid, cfg)
    return torch.relu(torch.cat([agg, h_self], dim=-1) @ layer_params["wo"])


def _tgn_layer_compact(params, layer_params, h_self, h_child, t_self, child,
                       cfg):
    """One attention layer: rows of h_self attend over their K
    neighbours' layer l-1 rows in the child hop's unique table, through
    the `embed_attn` kernel with cfg.use_kernels, else gathered from the
    table (`index_select`: many slots share a row) and attended by
    `neighbor_attention`."""
    rows = h_self.shape[0]
    kk = child["valid"].shape[1]
    dt = t_self[:, None] - child["t_edge"]
    if cfg.use_kernels:
        agg = kops.embed_attn(
            h_self, h_child,
            child["inverse"].reshape(rows, kk).to(torch.int32), dt,
            child["valid"], params["time"]["w"], params["time"]["b"],
            layer_params["wq"], layer_params["wk"], layer_params["wv"],
            n_heads=cfg.n_heads, mode=cfg.kernels_mode)
    else:
        h_nbr = annotate.events(
            h_child.index_select(0, child["inverse"].reshape(-1)))
        t_enc = modules.time_encode(params["time"], dt)
        kv_in = torch.cat([h_nbr.reshape(rows, kk, -1), t_enc], dim=-1)
        q = h_self @ layer_params["wq"]
        k = kv_in @ layer_params["wk"]
        v = kv_in @ layer_params["wv"]
        agg = neighbor_attention(q, k, v, child["valid"], cfg)
    return torch.relu(torch.cat([agg, h_self], dim=-1) @ layer_params["wo"])


def _hop_rows(mem, hops):
    # index_select, not mem[idx]: the backward of an indexing gather
    # accumulates duplicates one warp per index, and padded or empty slots
    # all read node 0; index_select's backward is index_add_. A bf16
    # table's rows are widened to fp32, as JAX's .astype(f32)
    return [annotate.events(mem.mem.index_select(0, hop["nodes"])).float()
            for hop in hops]


def _tgn_apply_dedup(params, cfg, state, nodes, t_query):
    """Hop 0 (the seeds) stays uncompacted; hop d >= 1 holds one row per
    distinct (node, time) key, computed once per layer."""
    n_layers = cfg.n_layers
    hops = batching.expand_frontiers_unique(state["neighbors"], nodes,
                                            t_query, n_layers, cfg.n_nodes)
    h = _hop_rows(state["memory"], hops)
    for l in range(1, n_layers + 1):
        lp = params["emb"][f"l{l - 1}"]
        h = [_tgn_layer_compact(params, lp, h[d], h[d + 1], hops[d]["t"],
                                hops[d + 1], cfg)
             for d in range(n_layers - l + 1)]
    return h[0]


def _tgn_apply_dense(params, cfg, state, nodes, t_query):
    """The seed expansion (cfg.dedup_embed=False): layer l computes h^(l)
    for every frontier level still needed (0 .. L - l), attending over the
    h^(l-1) rows of the next level; h^(0) is the memory row. The work is
    sum_d M * K**d rows a layer."""
    n_layers = cfg.n_layers
    hops = batching.expand_frontiers(state["neighbors"], nodes, t_query,
                                     n_layers)
    h = _hop_rows(state["memory"], hops)
    for l in range(1, n_layers + 1):
        lp = params["emb"][f"l{l - 1}"]
        h = [_tgn_layer(params, lp, h[d], h[d + 1], hops[d]["t"],
                        hops[d + 1]["t"], hops[d + 1]["valid"], cfg)
             for d in range(n_layers - l + 1)]
    return h[0]


def tgn_apply(params, cfg, state, nodes, t_query):
    """L-hop temporal graph attention (TGN): the deduplicated path with
    cfg.dedup_embed, the dense expansion without."""
    if cfg.dedup_embed:
        return _tgn_apply_dedup(params, cfg, state, nodes, t_query)
    return _tgn_apply_dense(params, cfg, state, nodes, t_query)


def jodie_apply(params, cfg, state, nodes, t_query):
    """JODIE: the memory row projected over the time since its last write,
    h = tanh(((1 + dt w_proj) . s) W_out), then cfg.n_layers - 1 layers
    h = tanh(h W). The memory rows are on the gradient path, so they are
    gathered with index_select."""
    mem = state["memory"]
    s = annotate.events(mem.mem.index_select(0, nodes)).float()
    l0 = params["emb"]["l0"]
    dt = (t_query - annotate.events(
        mem.last_update.index_select(0, nodes)))[:, None]
    h = torch.tanh((s * (1.0 + dt * l0["w_proj"][0])) @ l0["w_out"])
    for l in range(1, cfg.n_layers):
        h = torch.tanh(h @ params["emb"][f"l{l}"]["w"])
    return h


def apan_apply(params, cfg, state, nodes, t_query):
    """APAN: cfg.n_layers stacked attention layers of the node's memory row
    (then of the previous layer's output) over its mailbox messages; every
    slot attends, empty ones included (zero messages), as in the
    reference. t_query is unused, as there."""
    s = annotate.events(state["memory"].mem.index_select(0, nodes))
    # (M, Km, d_msg)
    msgs = annotate.events(state["mailbox"]["msg"].index_select(0, nodes))
    valid = torch.ones(msgs.shape[:2], dtype=torch.bool, device=msgs.device)
    h = s
    for l in range(cfg.n_layers):
        lp = params["emb"][f"l{l}"]
        q = h @ lp["wq"]
        k = msgs @ lp["wk"]
        v = msgs @ lp["wv"]
        agg = neighbor_attention(q, k, v, valid, cfg)
        h = torch.relu(torch.cat([agg, h], dim=-1) @ lp["wo"])
    return h


# model variant -> its embedding (the reference's VARIANT_EMBEDDINGS)
VARIANT_EMBEDDINGS = {"tgn": tgn_apply, "jodie": jodie_apply,
                      "apan": apan_apply}
