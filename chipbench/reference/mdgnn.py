"""The plain reference of TGN with PRES (the paper's Alg. 1 and Alg. 2,
lag-one), in plain PyTorch at float32 with TF32 off, written from the
model's equations and independent of the program under test: it imports
nothing of it and takes nothing it made. It rebuilds from the inputs what
the program derives: the neighbour rings, each node's last occurrence,
the PRES trackers and the k-hop frontier, which it expands densely (every
seed's K**d neighbours) where the program deduplicates; the two are the
same mathematics.

The model, per temporal batch of events (src, dst, t, edge feature):
  message   m = MLP([s_self, s_other, e, cos(dt w + b)]), dt = t - t_last
  memory    s_meas = GRU(m, s_prev) for every endpoint occurrence; each
            node keeps its chronologically last occurrence
  PRES      s_pred = s_prev + clip(c * mean_delta, -1, 1) (c the node's
            occurrences in the batch, mean_delta its tracker mean),
            s = (1 - g) s_pred + g s_meas, g = sigmoid(gamma_logit);
            the tracker adds (s - s_prev) / max(c, 1)
  embedding L layers of 2-head temporal attention over the K most recent
            neighbours, keys and values from [h_neighbour, cos(dt w + b)]
  decoder   relu([h_src, h_dst] W1 + b1) W2 + b2
  loss      mean BCE over positives and negatives, plus with PRES
            beta * (1 - cos(S_prev, S)) over the written rows (Eq. 10)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_shapes(cfg: dict) -> dict:
    """The parameter tree of TGN, in the layout the program takes."""
    dm, dmsg, dt, e = cfg["d_mem"], cfg["d_msg"], cfg["d_time"], cfg["d_embed"]
    shapes = {
        "time": {"w": (dt,), "b": (dt,)},
        "msg": {"w1": (2 * dm + cfg["d_edge"] + dt, dmsg), "b1": (dmsg,),
                "w2": (dmsg, dmsg), "b2": (dmsg,)},
        "mem": {"w": (dmsg, 3 * dm), "u": (dm, 3 * dm), "b": (3 * dm,)},
        "emb": {},
        "dec": {"w1": (2 * e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "node_cls": {"w1": (e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "pres": {"gamma_logit": ()},
    }
    for l in range(cfg["n_layers"]):
        d_in = dm if l == 0 else e
        shapes["emb"][f"l{l}"] = {"wq": (d_in, e), "wk": (d_in + dt, e),
                                  "wv": (d_in + dt, e), "wo": (e + d_in, e)}
    return shapes


def leaf_paths(tree, prefix=()):
    """(path, leaf) pairs in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def make_params(cfg: dict, seed: int, device) -> dict:
    """The weights of `seed`, made on `device` in one draw: normal with std
    1 / sqrt(fan_in) for weights, 1 for the time frequencies, zeros for
    biases and the PRES gate logit. Both the program and the reference
    are given these."""
    paths = list(leaf_paths(param_shapes(cfg)))
    sizes = [math.prod(s) for _, s in paths]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: dict = {}
    off = 0
    for (path, shape), n in zip(paths, sizes):
        leaf = path[-1]
        if leaf.startswith("b") or leaf == "gamma_logit":
            value = torch.zeros(shape, device=device)
        else:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            std = 1.0 if path == ("time", "w") else 1.0 / math.sqrt(fan_in)
            value = (flat[off:off + n] * std).reshape(shape).contiguous()
        off += n
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[leaf] = value
    # every subtree in the layout's order, empty ones too
    return {k: out.get(k, {}) for k in param_shapes(cfg)}


def time_encode(p, dt):
    """cos(dt w + b), the angle rounded to float32 once (its float64 value
    is exact to the last bit of float32)."""
    ang = dt.double()[..., None] * p["w"].double() + p["b"].double()
    return torch.cos(ang.float())


def message(p, s_self, s_other, feat, t_enc):
    x = torch.cat([s_self, s_other, feat, t_enc], dim=-1)
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def gru(p, x, h):
    d = h.shape[-1]
    gx = x @ p["w"] + p["b"]
    gh = h @ p["u"]
    r = torch.sigmoid(gx[:, :d] + gh[:, :d])
    z = torch.sigmoid(gx[:, d:2 * d] + gh[:, d:2 * d])
    n = torch.tanh(gx[:, 2 * d:] + r * gh[:, 2 * d:])
    return (1 - z) * h + z * n


class State:
    """Memory rows, last-write times, PRES tracker counts and delta sums
    (the tracker mean is all that Eq. 7 reads), and the neighbour rings
    (the K most recent (neighbour, time) pairs of each node)."""

    def __init__(self, cfg: dict, device):
        n, d, k = cfg["n_nodes"], cfg["d_mem"], cfg["n_neighbors"]
        self.mem = torch.zeros((n, d), device=device)
        self.last = torch.zeros(n, device=device)
        self.count = torch.zeros(n, device=device)
        self.dsum = torch.zeros((n, d), device=device)
        self.nbr = torch.full((n, k), -1, dtype=torch.int64, device=device)
        self.nbr_t = torch.zeros((n, k), device=device)
        self.fill = torch.zeros(n, dtype=torch.int64, device=device)


def occurrences(src, dst, t, feat, mask):
    """Endpoint occurrences, sources then destinations."""
    return (torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([t, t]),
            torch.cat([feat, feat]), torch.cat([mask, mask]))


def last_occurrence(nodes, mask, n_nodes: int):
    """True at each node's last valid occurrence. Events come in time
    order and a node is a source or a destination of an event, never
    both, so the last is the one of the latest event."""
    m = nodes.shape[0]
    b = m // 2
    pos = torch.arange(m, device=nodes.device)
    rank = torch.where(mask, (pos % b) * 2 + (pos >= b).long(),
                       torch.full_like(pos, -1))
    best = torch.full((n_nodes,), -1, dtype=torch.int64, device=nodes.device)
    best.scatter_reduce_(0, nodes, rank, reduce="amax")
    return mask & (best[nodes] == rank)


def memory_stage(params, cfg: dict, st: State, src, dst, t, feat, mask,
                 use_pres: bool):
    """The memory update of one batch, out of place. Returns (new memory
    table, info): the occurrences' nodes, last-occurrence flags, previous
    rows, written (fused) rows and tracker deltas."""
    nodes, other, times, f2, m2 = occurrences(src, dst, t, feat, mask)
    s_self, s_other = st.mem[nodes], st.mem[other]
    msgs = message(params["msg"], s_self, s_other, f2,
                   time_encode(params["time"], times - st.last[nodes]))
    s_meas = gru(params["mem"], msgs, s_self)
    sel = last_occurrence(nodes, m2, cfg["n_nodes"])
    if use_pres:
        cnt = torch.zeros(cfg["n_nodes"], device=nodes.device).index_add(
            0, nodes, m2.float())[nodes]
        mean = st.dsum[nodes] / torch.clamp(st.count[nodes], min=1.0)[:, None]
        s_pred = s_self + torch.clamp(cnt[:, None] * mean, -1.0, 1.0)
        g = torch.sigmoid(params["pres"]["gamma_logit"])
        fused = (1 - g) * s_pred + g * s_meas
        delta = (fused - s_self) / torch.clamp(cnt, min=1.0)[:, None]
    else:
        fused, delta = s_meas, None
    idx = nodes[sel]
    mem = st.mem.index_put((idx,), fused[sel])
    info = {"nodes": nodes, "sel": sel, "times": times, "s_prev": s_self,
            "fused": fused, "delta": delta}
    return mem, info


def commit(st: State, mem, info, use_pres: bool, src, dst, t, mask):
    """The state after a batch: the new rows and times, the trackers, and
    the batch appended to the rings."""
    sel, nodes = info["sel"], info["nodes"]
    st.mem = mem.detach()
    st.last = st.last.index_put((nodes[sel],), info["times"][sel])
    if use_pres:
        st.count = st.count.index_add(0, nodes[sel],
                                      torch.ones_like(info["times"][sel]))
        st.dsum = st.dsum.index_add(0, nodes[sel],
                                    info["delta"][sel].detach())
    append_rings(st, src, dst, t, mask)


def append_rings(st: State, src, dst, t, mask):
    """Each event appends its other endpoint and its time to both
    endpoints' rings, sources' occurrences first; a ring keeps its K most
    recent entries."""
    nodes, other, times, _, m2 = occurrences(src, dst, t, src[:, None], mask)
    nodes, other, times = nodes[m2], other[m2], times[m2]
    k = st.nbr.shape[1]
    order = torch.sort(nodes, stable=True).indices
    ns = nodes[order]
    first = torch.searchsorted(ns, ns, right=False)
    rank = torch.arange(ns.shape[0], device=ns.device) - first
    total = torch.bincount(ns, minlength=st.nbr.shape[0])
    keep = rank >= total[ns] - k
    slot = (st.fill[ns] + rank) % k
    ns, slot, o = ns[keep], slot[keep], order[keep]
    st.nbr[ns, slot] = other[o]
    st.nbr_t[ns, slot] = times[o]
    st.fill = (st.fill + total) % k


def attention_layer(p_time, lp, h_self, h_nbr, dt, valid, n_heads: int):
    """One temporal attention layer: rows h_self (R, ds) over their K
    neighbours' rows h_nbr (R, K, dn) at time gaps dt (R, K)."""
    r, k = valid.shape
    kv = torch.cat([h_nbr, time_encode(p_time, dt)], dim=-1)
    q = (h_self @ lp["wq"]).reshape(r, n_heads, -1)
    key = (kv @ lp["wk"]).reshape(r, k, n_heads, -1)
    val = (kv @ lp["wv"]).reshape(r, k, n_heads, -1)
    score = torch.einsum("rhe,rkhe->rhk", q, key) / math.sqrt(q.shape[-1])
    score = score.masked_fill(~valid[:, None, :], float("-inf"))
    any_valid = valid.any(dim=1)[:, None, None]
    prob = torch.where(any_valid, torch.softmax(
        torch.where(any_valid, score, torch.zeros_like(score)), dim=-1),
        torch.zeros_like(score))
    agg = torch.einsum("rhk,rkhe->rhe", prob, val).reshape(r, -1)
    return torch.relu(torch.cat([agg, h_self], dim=-1) @ lp["wo"])


def embed(params, cfg: dict, mem, st: State, nodes, t):
    """L-layer temporal attention embeddings of `nodes` at times `t`, over
    the dense L-hop expansion of the rings."""
    levels = [(nodes, t)]
    valids = []
    for _ in range(cfg["n_layers"]):
        n_, _t = levels[-1]
        nb = st.nbr[n_]
        valids.append(nb >= 0)
        levels.append((nb.clamp(min=0).reshape(-1), st.nbr_t[n_].reshape(-1)))
    h = [mem[n_] for n_, _ in levels]
    k = cfg["n_neighbors"]
    for l in range(cfg["n_layers"]):
        lp = params["emb"][f"l{l}"]
        h = [attention_layer(
            params["time"], lp, h[d], h[d + 1].reshape(h[d].shape[0], k, -1),
            levels[d][1][:, None] - levels[d + 1][1].reshape(-1, k),
            valids[d], cfg["n_heads"])
            for d in range(cfg["n_layers"] - l)]
    return h[0]


def decode(params, h_src, h_dst):
    p = params["dec"]
    x = torch.cat([h_src, h_dst], dim=-1)
    return (torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])[:, 0]

