"""MDGNN engine, TGN subset (counterpart of `repro/models/mdgnn.py`):
configuration, parameters, runtime state, the MESSAGE stage and its
per-occurrence bookkeeping, the embedding entry point and the link
decoder.

Only the configuration the serving slice implements is accepted
(`check_supported`); every other option raises NotImplementedError naming
the ROADMAP item that ports it."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import batching
from repro_torch.core.pres import PresState
from repro_torch.device import resolve_device
from repro_torch.graph.events import EventBatch
from repro_torch.models import embeddings, modules
from repro_torch.models.modules import MemoryState


@dataclasses.dataclass(frozen=True)
class MDGNNConfig:
    """Same fields and defaults as the JAX `MDGNNConfig`."""
    variant: str                 # tgn | jodie | apan
    n_nodes: int
    d_edge: int
    d_mem: int = 100
    d_msg: int = 100
    d_time: int = 32
    d_embed: int = 100
    n_neighbors: int = 10
    n_layers: int = 1
    n_heads: int = 2
    mailbox_size: int = 10
    memory_cell: str = "gru"
    aggregator: str = "last"
    use_pres: bool = False
    use_smoothing: bool | None = None
    beta: float = 0.1
    delta_mode: str = "transition"
    pres_scale: str = "count"
    pres_clip: float = 1.0
    anchor_fraction: float = 1.0
    pres_buckets: int | None = None
    mem_dtype: str = "float32"
    dedup_embed: bool = True
    use_kernels: bool = False
    kernels_mode: str = "auto"
    pipeline_depth: int = 0
    scan_chunk: int = 1
    event_store: str | None = None
    n_shards: int = 1
    shard_budget: int | None = None
    obs_metrics: bool = False


# field -> (the value this slice implements, the ROADMAP item porting others)
_SUPPORTED = {
    "variant": ("tgn", "Queue 1 item 11 (rest of the MDGNN model family)"),
    "use_pres": (True, "Queue 1 item 11 and Queue 2 item 5 (gru_cell)"),
    "memory_cell": ("gru", "Queue 1 item 11 (the rnn cell)"),
    "aggregator": ("last", "Queue 1 item 11 (aggregator='mean')"),
    "pres_scale": ("count", "Queue 1 item 11 (pres_scale='time')"),
    "anchor_fraction": (1.0, "Queue 1 item 11 (the anchor mask)"),
    "pres_buckets": (None, "Queue 1 item 11 (pres_buckets)"),
    "mem_dtype": ("float32", "Queue 1 item 11 (mem_dtype='bfloat16')"),
    "dedup_embed": (True, "Queue 1 item 7 and Queue 2 item 4 "
                          "(dense TGN path, neighbor_attn)"),
    "use_kernels": (True, "Queue 1 item 11 (use_kernels=False routing)"),
    "pipeline_depth": (0, "Queue 1 item 12 (pipelined schedule)"),
    "scan_chunk": (1, "Queue 1 item 15 (scan macro-batches)"),
    "event_store": (None, "Queue 1 item 17 (event store)"),
    "n_shards": (1, "Queue 1 item 18 (memory parallelism)"),
    "obs_metrics": (False, "Queue 1 item 14 (telemetry)"),
}


def check_supported(cfg: MDGNNConfig) -> None:
    """Raise NotImplementedError for any option outside the ported slice."""
    for field, (value, item) in _SUPPORTED.items():
        got = getattr(cfg, field)
        if got != value:
            raise NotImplementedError(
                f"repro_torch implements {field}={value!r} only, got "
                f"{got!r}; ROADMAP {item} ports the rest")
    if cfg.delta_mode not in ("transition", "innovation"):
        raise ValueError(f"unknown delta_mode {cfg.delta_mode!r}")
    if cfg.n_layers < 1 or cfg.d_embed % cfg.n_heads:
        raise ValueError(f"need n_layers >= 1 and d_embed divisible by "
                         f"n_heads, got {cfg.n_layers}, {cfg.d_embed}, "
                         f"{cfg.n_heads}")


# ---------------------------------------------------------------------------
# Parameters and state
# ---------------------------------------------------------------------------


def param_shapes(cfg: MDGNNConfig) -> dict:
    """Nested dict of parameter shapes, in the JAX tree's layout."""
    d_in_msg = 2 * cfg.d_mem + cfg.d_edge + cfg.d_time
    e = cfg.d_embed
    shapes = {
        "time": {"w": (cfg.d_time,), "b": (cfg.d_time,)},
        "msg": {"w1": (d_in_msg, cfg.d_msg), "b1": (cfg.d_msg,),
                "w2": (cfg.d_msg, cfg.d_msg), "b2": (cfg.d_msg,)},
        "mem": {"w": (cfg.d_msg, 3 * cfg.d_mem),
                "u": (cfg.d_mem, 3 * cfg.d_mem), "b": (3 * cfg.d_mem,)},
        "emb": {},
        "dec": {"w1": (2 * e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "node_cls": {"w1": (e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "pres": {"gamma_logit": ()},
    }
    for l in range(cfg.n_layers):
        d_in = cfg.d_mem if l == 0 else e
        shapes["emb"][f"l{l}"] = {
            "wq": (d_in, e), "wk": (d_in + cfg.d_time, e),
            "wv": (d_in + cfg.d_time, e), "wo": (e + d_in, e)}
    return shapes


def init_params(cfg: MDGNNConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters by the JAX package's scheme (nn/module.py): normal
    with std 1/sqrt(fan_in) for weights, zeros for biases and the PRES gate
    logit, std 1.0 for the time-encoder frequencies. Drawn on the CPU from
    `generator`, then moved to `device` (cuda unless "cpu" is passed). The
    draws are not jax.random's bits."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)

    def make(path, shape):
        leaf = path[-1]
        if leaf.startswith("b") or leaf == "gamma_logit":
            value = torch.zeros(shape, dtype=torch.float32)
        else:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            std = 1.0 if path == ("time", "w") else 1.0 / math.sqrt(fan_in)
            value = torch.randn(shape, generator=gen) * std
        return value.to(dev)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else make(path + (k,), v) for k, v in tree.items()}

    return walk(param_shapes(cfg), ())


def init_state(cfg: MDGNNConfig, device=None) -> dict:
    """Zero memory, empty neighbour rings and PRES trackers on `device`
    (rings and trackers carry a trailing dump row, see core/)."""
    dev = resolve_device(device)
    return {
        "memory": MemoryState.init(cfg.n_nodes, cfg.d_mem, dev),
        "neighbors": batching.init_neighbors(cfg.n_nodes, cfg.n_neighbors,
                                             dev),
        "pres": PresState.init(cfg.n_nodes, cfg.d_mem, dev),
    }


# ---------------------------------------------------------------------------
# MESSAGE + per-occurrence bookkeeping
# ---------------------------------------------------------------------------


def compute_messages(params, cfg: MDGNNConfig, mem: MemoryState,
                     batch: EventBatch):
    """Messages for every endpoint occurrence ([srcs..., dsts...])."""
    nodes, times, other, feat, mask = batching.node_occurrences(batch)
    s_self = mem.mem[nodes]
    s_other = mem.mem[other]
    dt = times - mem.last_update[nodes]
    t_enc = modules.time_encode(params["time"], dt)
    msgs = modules.message(params["msg"], s_self, s_other, feat, t_enc)
    return nodes, times, msgs, mask


def occurrence_order(nodes, times, mask):
    """Permutation grouping occurrences by node (masked ones last), each
    node's chronologically-last occurrence final within its group; ties
    keep array order (two stable sorts, as jnp.lexsort)."""
    big = torch.where(mask, times, torch.full_like(times, -math.inf))
    keyed = torch.where(mask, nodes, torch.full_like(nodes,
                                                     batching.INT32_MAX))
    return batching.lexsort((big, keyed))


def _last_occurrence_flags(nodes, times, mask):
    """True for the chronologically-last valid occurrence of each node."""
    m = nodes.shape[0]
    order = occurrence_order(nodes, times, mask)
    n_sorted = nodes[order]
    m_sorted = mask[order]
    is_last = torch.ones(m, dtype=torch.bool, device=nodes.device)
    is_last[:-1] = (n_sorted[1:] != n_sorted[:-1]) | ~m_sorted[1:]
    flags = torch.zeros(m, dtype=torch.bool, device=nodes.device)
    flags[order] = is_last & m_sorted
    return flags


def memory_inputs(params, cfg: MDGNNConfig, mem: MemoryState,
                  batch: EventBatch):
    """MESSAGE stage + selection flags for the fused memory update:
    (nodes, times, msgs, mask, selected). Unlike the JAX version it does
    not gather the previous rows: the memory_update_table kernel does."""
    nodes, times, msgs, mask = compute_messages(params, cfg, mem, batch)
    selected = _last_occurrence_flags(nodes, times, mask)
    return nodes, times, msgs, mask, selected


# ---------------------------------------------------------------------------
# EMBEDDING and decoder
# ---------------------------------------------------------------------------


def embed_nodes(params, cfg: MDGNNConfig, state, nodes, t_query):
    """Dynamic embeddings h_i(t) (TGN dedup attention, cfg.n_layers hops)."""
    return embeddings.tgn_apply(params, cfg, state, nodes, t_query)


def link_logits(params, h_src, h_dst):
    x = torch.cat([h_src, h_dst], dim=-1)
    h = torch.relu(x @ params["dec"]["w1"] + params["dec"]["b1"])
    return (h @ params["dec"]["w2"] + params["dec"]["b2"])[..., 0]
