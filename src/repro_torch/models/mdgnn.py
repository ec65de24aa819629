"""MDGNN engine, TGN, JODIE and APAN (counterpart of
`repro/models/mdgnn.py`): configuration, parameters, runtime state, the
MESSAGE stage and its per-occurrence bookkeeping, the batch-parallel memory
update and its sequential oracle, APAN's mailbox, the embedding entry point
and the link and node decoders.

`check_supported` raises ValueError for a value the reference does not
define. With n_shards > 1 the node tables are sharded and the engines
route through `train/routing.py`; with mem_dtype="bfloat16" the memory
rows are stored in bf16 and widened to fp32 wherever they are read."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import batching
from repro_torch.core.pres import PRES_STATE_AXES, PresState
from repro_torch.device import resolve_device
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.models import embeddings, modules
from repro_torch.models.modules import MemoryState
from repro_torch.train import annotate


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


# field -> every value the reference defines
_CHOICES = {
    "mem_dtype": ("float32", "bfloat16"),
    "variant": ("tgn", "jodie", "apan"),
    "memory_cell": ("gru", "rnn"),
    "aggregator": ("last", "mean"),
    "pres_scale": ("count", "time"),
    "delta_mode": ("transition", "innovation"),
}


def check_supported(cfg: MDGNNConfig) -> None:
    """Raise ValueError for a value the reference does not define, and for
    n_shards < 1 or shard_budget < 1.

    Every `pres_buckets` and `use_kernels` value is accepted (False: the
    plain route, which launches no kernel). So is every
    `anchor_fraction`, which, as in the JAX engine, nothing reads: the
    anchor mask is `pres.make_anchor_mask`, passed to
    `pres.update_trackers` by its caller."""
    if cfg.n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {cfg.n_shards}")
    if cfg.shard_budget is not None and cfg.shard_budget < 1:
        raise ValueError(f"shard_budget must be >= 1 (or None: the "
                         f"overflow-free default), got {cfg.shard_budget}")
    for field, values in _CHOICES.items():
        if getattr(cfg, field) not in values:
            raise ValueError(f"unknown {field} {getattr(cfg, field)!r}; "
                             f"one of {values}")
    # JODIE has no attention heads (jodie_init checks the depth only)
    heads_ok = cfg.variant == "jodie" or cfg.d_embed % cfg.n_heads == 0
    if cfg.n_layers < 1 or not heads_ok:
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
        "mem": modules.MEMORY_CELL_SHAPES[cfg.memory_cell](cfg.d_msg,
                                                           cfg.d_mem),
        "emb": {},
        "dec": {"w1": (2 * e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "node_cls": {"w1": (e, e), "b1": (e,), "w2": (e, 1), "b2": (1,)},
        "pres": {"gamma_logit": ()},
    }
    if cfg.variant == "jodie":
        # jodie_init: the time projection, then d_embed-wide layers
        shapes["emb"]["l0"] = {"w_proj": (1, cfg.d_mem),
                               "w_out": (cfg.d_mem, e)}
        for l in range(1, cfg.n_layers):
            shapes["emb"][f"l{l}"] = {"w": (e, e)}
        return shapes
    # keys and values: TGN's from [neighbour row, time encoding] (tgn_init),
    # APAN's from the mailbox messages (apan_init)
    for l in range(cfg.n_layers):
        d_in = cfg.d_mem if l == 0 else e
        d_kv = cfg.d_msg if cfg.variant == "apan" else d_in + cfg.d_time
        shapes["emb"][f"l{l}"] = {
            "wq": (d_in, e), "wk": (d_kv, e), "wv": (d_kv, e),
            "wo": (e + d_in, e)}
    return shapes


def param_axes(cfg: MDGNNConfig) -> dict:
    """The logical sharding axes of every parameter, in `param_shapes`'
    layout (JAX's `init_params` builds the same tree beside the values):
    weights ("embed", "mlp"), biases ("mlp",); the time encoder, the
    decoders' output layer and the PRES gate unsharded."""
    mat, vec = ("embed", "mlp"), ("mlp",)
    head = {"w1": mat, "b1": vec, "w2": ("mlp", None), "b2": (None,)}
    axes = {
        "time": {"w": (None,), "b": (None,)},
        "msg": {"w1": mat, "b1": vec, "w2": ("mlp", "mlp"), "b2": vec},
        "mem": {"w": mat, "u": mat, "b": vec},
        "emb": {},
        "dec": dict(head),
        "node_cls": dict(head),
        "pres": {"gamma_logit": ()},
    }
    if cfg.variant == "jodie":
        axes["emb"]["l0"] = {"w_proj": (None, "embed"), "w_out": mat}
        for l in range(1, cfg.n_layers):
            axes["emb"][f"l{l}"] = {"w": mat}
        return axes
    for l in range(cfg.n_layers):
        axes["emb"][f"l{l}"] = {"wq": mat, "wk": mat, "wv": mat, "wo": mat}
    return axes


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
    """Zero memory, empty neighbour rings and PRES trackers on `device`,
    and for APAN an empty mailbox (`msg` (N + 1, mailbox_size, d_msg), `t`
    (N + 1, mailbox_size), `ptr` (N + 1,)). The trackers have a row per
    node, or per hash bucket with `pres_buckets`. Rings, trackers and
    mailbox carry a trailing dump row (see core/). The memory rows take
    cfg.mem_dtype; `last_update` and everything else stay float32. The
    state is in the natural layout: `routing.shard_state` shards it."""
    dev = resolve_device(device)
    state = {
        "memory": MemoryState.init(cfg.n_nodes, cfg.d_mem, dev,
                                   dtype=getattr(torch, cfg.mem_dtype)),
        "neighbors": batching.init_neighbors(cfg.n_nodes, cfg.n_neighbors,
                                             dev),
        "pres": PresState.init(cfg.pres_buckets or cfg.n_nodes, cfg.d_mem,
                               dev),
    }
    if cfg.variant == "apan":
        n, km = cfg.n_nodes + 1, cfg.mailbox_size
        state["mailbox"] = {
            "msg": torch.zeros((n, km, cfg.d_msg), dtype=torch.float32,
                               device=dev),
            "t": torch.zeros((n, km), dtype=torch.float32, device=dev),
            "ptr": torch.zeros((n,), dtype=torch.int32, device=dev)}
    return state


# logical sharding axes of `init_state`'s tree
STATE_AXES = {
    "memory": modules.MEMORY_STATE_AXES,
    "neighbors": batching.NEIGHBOR_AXES,
    "pres": PRES_STATE_AXES,
    "mailbox": {"msg": ("nodes", None, "embed"), "t": ("nodes", None),
                "ptr": ("nodes",)},
}


def clone_state(state) -> dict:
    """A copy of the runtime state that shares no storage with it (a
    sharded state's per-shard lists too)."""
    def cp(x):
        if isinstance(x, list):
            return [t.detach().clone() for t in x]
        return x.detach().clone()

    mem, pr = state["memory"], state["pres"]
    out = {
        "memory": MemoryState(mem=cp(mem.mem), last_update=cp(mem.last_update)),
        "neighbors": {k: cp(v) for k, v in state["neighbors"].items()},
        "pres": PresState(n=cp(pr.n), xi=cp(pr.xi), psi=cp(pr.psi)),
    }
    if "mailbox" in state:
        out["mailbox"] = {k: cp(v) for k, v in state["mailbox"].items()}
    return out


# ---------------------------------------------------------------------------
# MESSAGE + per-occurrence bookkeeping
# ---------------------------------------------------------------------------


def compute_messages(params, cfg: MDGNNConfig, mem: MemoryState,
                     batch: EventBatch):
    """Messages for every endpoint occurrence ([srcs..., dsts...])."""
    nodes, times, other, feat, mask = batching.node_occurrences(batch)
    # gathered rows pinned to the event axes (train/annotate.py)
    s_self = annotate.events(mem.mem[nodes]).float()
    s_other = annotate.events(mem.mem[other]).float()
    dt = times - annotate.events(mem.last_update[nodes])
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


def scatter_rows(table, write_idx, values):
    """Masked row scatter with the drop-slot trick, out of place: index N
    (one past the end) is a dump row for masked-off writes, so the scatter
    stays dense and waits for nothing on the host. `values` are cast to
    the table's dtype. Returns the new (N, ...) table (autograd records
    the write)."""
    pad = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    out = torch.cat([table, pad]).index_put(
        (write_idx.long(),), values.to(table.dtype))
    return out[:-1]


def memory_inputs(params, cfg: MDGNNConfig, mem: MemoryState,
                  batch: EventBatch):
    """MESSAGE stage + per-occurrence bookkeeping shared by the cell-based
    memory update below and the fused-kernel path
    (train/loop.py::_fused_memory_update): (nodes, times, msgs, mask,
    selected). With aggregator="mean" every occurrence carries its node's
    mean message of the batch."""
    nodes, times, msgs, mask = compute_messages(params, cfg, mem, batch)
    if cfg.aggregator == "mean":
        mean_n, _ = batching.mean_per_node(nodes, msgs, mask, cfg.n_nodes)
        msgs = mean_n.index_select(0, nodes)
    selected = annotate.local(_last_occurrence_flags, nodes, times, mask)
    return nodes, times, msgs, mask, selected


def memory_cell(cfg: MDGNNConfig, p, x, h):
    """The configured memory cell on rows x (M, d_msg), h (M, d_mem): with
    cfg.use_kernels the `gru_cell` kernel for the GRU, else the plain
    `modules.gru_cell`; the plain `modules.rnn_cell` for the rnn cell (the
    JAX package has no kernel for it)."""
    if cfg.memory_cell == "rnn":
        return modules.rnn_cell(p, x, h)
    if cfg.use_kernels:
        return kops.gru_cell(x, h, p["w"], p["u"], p["b"],
                             mode=cfg.kernels_mode)
    return modules.gru_cell(p, x, h)


def memory_update(params, cfg: MDGNNConfig, mem: MemoryState,
                  batch: EventBatch, defer_write: bool = False):
    """Batch-parallel memory transition: the memory cell runs on the 2b
    endpoint occurrences and only each node's selected (chronologically
    last) occurrence is written back, IN PLACE on `mem`, through
    `batching.write_selected`: one write of fixed shape over the 2b
    occurrences, which waits for nothing on the host, so a CUDA graph
    holds it. Autograd records the write, so the new rows pass their
    gradient on to whatever later reads `mem.mem`. With `defer_write`
    (PRES: `loop._apply_pres` writes the fused rows instead) only
    `last_update` is written, so no row is written twice.

    Returns (mem, info). info carries the rows PRES and the coherence loss
    need and `t_prev` (with pres_scale="time": the occurrences' last-update
    times, gathered BEFORE the write, since the scale is 0 for every node
    read after it; else None)."""
    nodes, times, msgs, mask, selected = memory_inputs(params, cfg, mem,
                                                       batch)
    h_prev = mem.mem[nodes].float()
    t_prev = (mem.last_update[nodes] if cfg.pres_scale == "time"
              else None)
    new_rows = memory_cell(cfg, params["mem"], msgs, h_prev)
    # compact-update boundary (train/annotate.py): the (2b, D) rows and
    # their bookkeeping, before the table scatter
    new_rows = annotate.compact(new_rows)
    times, selected = annotate.compact(times), annotate.compact(selected)
    nodes = annotate.compact(nodes)
    if not defer_write:
        mem.mem = annotate.local(batching.write_selected, mem.mem, nodes,
                                 selected, new_rows)
    mem.last_update = annotate.local(batching.write_selected,
                                     mem.last_update, nodes, selected, times)
    info = {"nodes": nodes, "selected": selected, "mask": mask,
            "s_prev": h_prev, "s_meas": new_rows, "t_prev": t_prev,
            "t_now": times, "msgs": msgs}
    return mem, info


def sequential_memory_update(params, cfg: MDGNNConfig, mem: MemoryState,
                             batch: EventBatch) -> MemoryState:
    """The sequential oracle (Fig. 2(b), middle row): the batch's events
    folded strictly one at a time through the plain memory cell, so no
    event reads a row its batch already changed without seeing that
    change. Returns a new MemoryState; `mem` is left as it was. A masked
    event leaves its rows and times alone. A loop over the b events, as
    JAX's lax.scan: an oracle, not a fast path."""
    cell = modules.gru_cell if cfg.memory_cell == "gru" else \
        modules.rnn_cell
    m, lu = mem.mem.clone(), mem.last_update.clone()
    for i in range(batch.src.shape[0]):
        pair = torch.stack([batch.src[i], batch.dst[i]])
        other = torch.stack([batch.dst[i], batch.src[i]])
        s_self, s_other = m[pair].float(), m[other].float()
        t_enc = modules.time_encode(params["time"], batch.t[i] - lu[pair])
        msgs = modules.message(params["msg"], s_self, s_other,
                               batch.feat[i].expand(2, -1), t_enc)
        new_rows = cell(params["mem"], msgs, s_self)
        upd = batch.mask[i].to(torch.float32)
        m[pair] = (upd * new_rows + (1 - upd) * s_self).to(m.dtype)
        lu[pair] = torch.where(batch.mask[i], batch.t[i], lu[pair])
    return MemoryState(mem=m, last_update=lu)


# ---------------------------------------------------------------------------
# EMBEDDING and decoder
# ---------------------------------------------------------------------------


def embed_nodes(params, cfg: MDGNNConfig, state, nodes, t_query):
    """Dynamic embeddings h_i(t) of the variant's EMBEDDING module (TGN
    attention over cfg.n_layers hops, JODIE's time projection, or APAN's
    mailbox attention)."""
    return embeddings.VARIANT_EMBEDDINGS[cfg.variant](params, cfg, state,
                                                      nodes, t_query)


def update_mailbox(mailbox, nodes, msgs, times, mask) -> None:
    """APAN: append each occurrence's message to its node's mailbox ring,
    IN PLACE (the neighbour rings' `batching.ring_buffer_append`). A node
    with more occurrences in the call than the mailbox holds keeps its
    last `mailbox_size` (ROADMAP Queue 3 P4); masked rows go to the dump
    row."""
    annotate.local(batching.ring_buffer_append,
                   {"msg": mailbox["msg"], "t": mailbox["t"]},
                   mailbox["ptr"], nodes, {"msg": msgs, "t": times}, mask,
                   writes=(0, 1))


def link_logits(params, h_src, h_dst):
    x = torch.cat([h_src, h_dst], dim=-1)
    h = torch.relu(x @ params["dec"]["w1"] + params["dec"]["b1"])
    return (h @ params["dec"]["w2"] + params["dec"]["b2"])[..., 0]


def node_logits(params, h):
    """Node-classification logits (Table 2) of embeddings h (M, d_embed)."""
    hh = torch.relu(h @ params["node_cls"]["w1"] + params["node_cls"]["b1"])
    return (hh @ params["node_cls"]["w2"] + params["node_cls"]["b2"])[..., 0]
