"""The logical sizes of the program's calls, rebuilt from the events the
harness fed it: neighbour rings replayed in the program's fold order (the
reference's rings), and from them each embedding's deduplicated frontier,
the distinct (node, time) rows of every hop that valid slots reach."""
from __future__ import annotations

import types

import torch

from chipbench.reference import mdgnn as ref


class Rings:
    """The neighbour rings alone, replayed batch by batch."""

    def __init__(self, cfg: dict, device):
        n, k = cfg["n_nodes"], cfg["n_neighbors"]
        self.cfg = cfg
        self.st = types.SimpleNamespace(
            nbr=torch.full((n, k), -1, dtype=torch.int64, device=device),
            nbr_t=torch.zeros((n, k), device=device),
            fill=torch.zeros(n, dtype=torch.int64, device=device))

    def append(self, src, dst, t, mask) -> None:
        ref.append_rings(self.st, src, dst, t, mask)

    def attention_calls(self, nodes, t, valid) -> list:
        """The sizes of each attention call (layer l, hop d) of an
        embedding of `nodes` at times `t` (rows where `valid`), in the
        program's order (layer by layer, hop by hop)."""
        cfg = self.cfg
        n_, t_ = _distinct(nodes[valid], t[valid])
        hops = []
        for _ in range(cfg["n_layers"]):
            nb = self.st.nbr[n_]
            ok = nb >= 0
            hops.append((n_.shape[0], int(ok.sum())))
            n_, t_ = _distinct(nb[ok], self.st.nbr_t[n_][ok])
        hops.append((n_.shape[0], 0))
        calls = []
        for l in range(cfg["n_layers"]):
            ds = cfg["d_mem"] if l == 0 else cfg["d_embed"]
            for d in range(cfg["n_layers"] - l):
                calls.append({"rows": hops[d][0], "valid_slots": hops[d][1],
                              "child_rows": hops[d + 1][0], "ds": ds,
                              "din": ds, "dtime": cfg["d_time"],
                              "e": cfg["d_embed"], "heads": cfg["n_heads"],
                              "k": cfg["n_neighbors"]})
        return calls


def _distinct(nodes, t):
    """The distinct (node, time) pairs."""
    bits = t.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = torch.unique(nodes.long() * (1 << 32) + bits)
    low = keys & 0xFFFFFFFF
    low = torch.where(low >= 1 << 31, low - (1 << 32), low)
    return keys >> 32, low.to(torch.int32).view(torch.float32)


def memory_sizes(cfg: dict, src, dst, mask) -> dict:
    """The memory stage's sizes of a folded batch: its valid endpoint
    occurrences and the distinct rows they write."""
    nodes = torch.cat([src[mask], dst[mask]])
    return {"occ": int(nodes.shape[0]),
            "rows_written": int(torch.unique(nodes).shape[0]),
            "d_msg": cfg["d_msg"], "d_mem": cfg["d_mem"]}
