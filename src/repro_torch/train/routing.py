"""Cross-shard event routing for memory-parallel training (counterpart of
`repro/train/routing.py`).

The memory, neighbour, PRES and mailbox tables are partitioned across
`n_shards` shards by `node_id % n_shards` (the DistTGL memory-parallel
direction). Because a mod-partition is not a contiguous row range, the
tables use the JAX package's *shard-major permuted layout*: node v lives
at physical row

    owner(v) * rows_per_shard + v // n_shards,   owner(v) = v % n_shards

padded to `rows_per_shard = ceil(N / n_shards)` rows a shard. A sharded
state keeps each table component as a list of per-shard tensors, shard s
on its device; concatenated, the lists equal JAX's `to_shard_layout`
arrays element for element. The port's rings, trackers and APAN mailbox
carry a dump row after their N rows (core/); a shard of such a component
carries its own dump row after its `rows_per_shard` rows, so every
owner-local update is the single-device function on local ids.
`shard_state` / `unshard_state` convert whole states; `unshard_state`
returns the single-device state, dump row included (shard 0's).

One process drives every shard (single-controller, like JAX's
`shard_map`). `get_mesh` gives the shard -> device list: the CPU for
every shard (the counterpart of JAX's emulated host mesh), one named card
for every shard, or shard i on `cuda:i`. The shards exchange data only
through the three collectives of the section below, `all_gather`, `psum`
and `all_to_all` over per-shard lists, made of `torch.cat`, sums and
`.to(device)` copies, so autograd gives their exact transposes as
`shard_map` does; an NCCL process group can take their place behind the
same three names without touching the protocol.

The per-batch protocol (`sharded_memory_and_pres`) is JAX's, phase for
phase:

1. request gather: each shard all-gathers the batch's touched node ids
   and answers for the rows it owns (masked contribution + psum): the
   pre-update memory rows, last-update times and GMM mixture means of
   every occurrence;
2. MESSAGE stage, event-sharded: each shard computes the messages of its
   contiguous slice of the 2b endpoint occurrences;
3. route: occurrences are bucketed by owner shard into a flat
   (n_shards * budget, ...) send buffer (`bucket_plan`: stable
   per-destination ranks) and delivered by ONE `all_to_all`; rows past
   the per-lane `budget` are masked out and COUNTED (`route_overflow`),
   never silently dropped. The default budget makes overflow impossible;
4. owner-local update: the owner recomputes the selected-last flags and
   the PRES scale from the routed occurrences (the global batch position
   breaks time ties as the single-device sort does) and updates its
   table slice: the `memory_update_table` kernel on its slice when PRES,
   the GRU cell and kernels are on (one launch a shard a step), else the
   memory cell and PRES Eq. 7-9 inline, as JAX computes them;
5. unroute: per-occurrence outputs take the reverse `all_to_all` back to
   their senders, so the loss sees them in batch order.

State maintenance (rings, trackers, mailbox) needs no routing: every
shard sees the replicated occurrences and updates only the rows it owns,
ownership folded into the mask. The embedding stack reads a natural-layout
view (`natural_state_view`, one all-gather and a permutation, exact in
its transpose)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import batching, pres
from repro_torch.device import resolve_device
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import mdgnn, modules
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.models.modules import MemoryState
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Mesh + shard-major permuted layout
# ---------------------------------------------------------------------------


def get_mesh(n_shards: int, device=None) -> tuple[torch.device, ...]:
    """The shard -> device list. "cpu" (or any non-CUDA device) and an
    explicit card such as "cuda:0" put every shard there; bare "cuda" or
    None puts shard i on cuda:i and raises ValueError when fewer than
    n_shards cards are visible (never a silent fallback to one device)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        if not torch.cuda.is_available():
            raise RuntimeError(f"n_shards={n_shards} on bare 'cuda' but CUDA "
                               f"is unavailable; pass device='cpu' to put "
                               f"every shard on the CPU")
        count = torch.cuda.device_count()
        if count < n_shards:
            raise ValueError(
                f"n_shards={n_shards} but only {count} CUDA device(s) "
                f"visible; pass an explicit device such as 'cuda:0' to put "
                f"every shard on one card")
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    return (resolve_device(dev),) * n_shards


def rows_per_shard(n_rows: int, n_shards: int) -> int:
    return -(-n_rows // n_shards)


def padded_rows(n_rows: int, n_shards: int) -> int:
    return rows_per_shard(n_rows, n_shards) * n_shards


def phys_index(ids, n_rows: int, n_shards: int):
    """Natural id -> physical row in the shard-major permuted layout."""
    per = rows_per_shard(n_rows, n_shards)
    return (ids % n_shards) * per + ids // n_shards


def to_shard_layout(x, n_rows: int, n_shards: int):
    """Natural (n_rows, ...) array -> permuted+padded (padded_rows, ...),
    the padding zeros; numpy in, numpy out, or a tensor in, a tensor out."""
    if isinstance(x, torch.Tensor):
        out = torch.zeros((padded_rows(n_rows, n_shards),) + x.shape[1:],
                          dtype=x.dtype, device=x.device)
        out[phys_index(torch.arange(n_rows, device=x.device), n_rows,
                       n_shards)] = x
        return out
    x = np.asarray(x)
    out = np.zeros((padded_rows(n_rows, n_shards),) + x.shape[1:], x.dtype)
    out[phys_index(np.arange(n_rows), n_rows, n_shards)] = x
    return out


def from_shard_layout(x, n_rows: int, n_shards: int):
    """Permuted+padded (padded_rows, ...) array -> natural (n_rows, ...)."""
    if isinstance(x, torch.Tensor):
        return x[phys_index(torch.arange(n_rows, device=x.device), n_rows,
                            n_shards)]
    x = np.asarray(x)
    return x[phys_index(np.arange(n_rows), n_rows, n_shards)]


def _component_rows(cfg: MDGNNConfig, name: str) -> int:
    """Leading-axis row count of a state component in natural layout (its
    dump row not counted)."""
    if name == "pres":
        return cfg.pres_buckets or cfg.n_nodes
    return cfg.n_nodes


def _map_component(fn, comp):
    """fn over the leaves of a state component (a dict, or the
    MemoryState / PresState dataclass)."""
    if dataclasses.is_dataclass(comp):
        return dataclasses.replace(comp, **{
            f.name: fn(getattr(comp, f.name))
            for f in dataclasses.fields(comp)})
    return {k: fn(v) for k, v in comp.items()}


def is_sharded(state) -> bool:
    """Whether `state` holds per-shard lists (`shard_state`'s output)."""
    return isinstance(state["memory"].mem, list)


def mesh_of(state) -> tuple[torch.device, ...]:
    """The devices of a sharded state's shards, in shard order."""
    if not is_sharded(state):
        raise ValueError(
            "n_shards > 1 needs the state in per-shard lists "
            "(routing.shard_state); the natural-layout state would run the "
            "single-device path")
    return tuple(t.device for t in state["memory"].mem)


def _shard_leaf(x, n_rows: int, mesh):
    n = len(mesh)
    per = rows_per_shard(n_rows, n)
    perm = to_shard_layout(x[:n_rows], n_rows, n)
    dump = x[n_rows:]                       # (1, ...) or empty
    return [torch.cat([perm[s * per:(s + 1) * per], dump]).to(dev, copy=True)
            for s, dev in enumerate(mesh)]


def shard_state(cfg: MDGNNConfig, state, mesh=None) -> dict:
    """Natural model state -> per-shard lists in the permuted layout, shard
    s on mesh[s] (default: every shard on the state's device). A
    component with a dump row gives each shard a copy of it. The inverse
    is `unshard_state`."""
    if mesh is None:
        mesh = get_mesh(cfg.n_shards, state["memory"].mem.device)
    if len(mesh) != cfg.n_shards:
        raise ValueError(f"a mesh of {len(mesh)} devices for "
                         f"n_shards={cfg.n_shards}")
    return {name: _map_component(
        lambda x, r=_component_rows(cfg, name): _shard_leaf(x.detach(), r,
                                                            mesh), comp)
        for name, comp in state.items()}


def unshard_state(cfg: MDGNNConfig, state, device=None) -> dict:
    """Per-shard state -> the natural single-device state on `device`
    (default shard 0's): every real row from its owner, the dump rows
    from shard 0."""
    return {name: _map_component(
        lambda xs, r=_component_rows(cfg, name): natural_rows(
            cfg, xs, r, device).detach().clone(), comp)
        for name, comp in state.items()}


def replicate(tree, mesh) -> list:
    """One copy of a nested dict of tensors per shard, on its device
    (shards on one device share one copy). `.to` is differentiable, so a
    gradient reaching any copy flows back to `tree`."""
    copies, out = {}, []
    for dev in mesh:
        if dev not in copies:
            copies[dev] = tree_map(lambda t: t.to(dev), tree)
        out.append(copies[dev])
    return out


def place_batch(batch: EventBatch, device) -> EventBatch:
    """A host-made event batch on the controller's device (the shards
    read it there): the counterpart of JAX's replicated step inputs."""
    if batch.src.device == device:
        return batch
    return EventBatch(*(getattr(batch, f.name).to(device)
                        for f in dataclasses.fields(batch)))


# ---------------------------------------------------------------------------
# Collectives: the only places where shards exchange data
# ---------------------------------------------------------------------------


def all_gather(xs, devices) -> list:
    """The shards' tensors concatenated in shard order, one copy per entry
    of `devices` (entries on one device share one copy)."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = torch.cat([x.to(dev) for x in xs])
    return [copies[dev] for dev in devices]


def psum(xs, devices) -> list:
    """The sum over shards of equally shaped tensors, one copy per entry
    of `devices`."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            acc = xs[0].to(dev)
            for x in xs[1:]:
                acc = acc + x.to(dev)
            copies[dev] = acc
    return [copies[dev] for dev in devices]


def all_to_all(xs, devices) -> list:
    """Tiled all-to-all over axis 0: shard s's tensor is n equal lanes;
    receiver r gets lane r of every sender, concatenated in sender order."""
    n = len(xs)
    lane = xs[0].shape[0] // n
    return [torch.cat([x[r * lane:(r + 1) * lane].to(dev) for x in xs])
            for r, dev in enumerate(devices)]


# ---------------------------------------------------------------------------
# Natural-layout read views
# ---------------------------------------------------------------------------


def natural_rows(cfg: MDGNNConfig, xs, n_rows: int, device=None):
    """The natural-layout (n_rows, ...) view of one sharded table, with a
    dump row (shard 0's) when its shards carry one, on `device` (default
    shard 0's): one all-gather and one `index_select`, whose transpose is
    exact, so the gradient from the loss reaches each shard's rows. With
    one shard the layout is the natural one and the shard is returned."""
    n = len(xs)
    dev = xs[0].device if device is None else torch.device(device)
    if n == 1:
        return xs[0].to(dev)
    local = xs[0].shape[0]                  # rows_per_shard (+ 1: dump)
    full = all_gather(xs, (dev,))[0]
    ids = torch.arange(n_rows, device=dev)
    idx = (ids % n) * local + ids // n
    if local == rows_per_shard(n_rows, n) + 1:
        idx = torch.cat([idx, torch.full((1,), local - 1, dtype=idx.dtype,
                                         device=dev)])
    return full.index_select(0, idx)


def natural_component_view(cfg: MDGNNConfig, comp, name: str, device=None):
    n_rows = _component_rows(cfg, name)
    return _map_component(lambda xs: natural_rows(cfg, xs, n_rows, device),
                          comp)


# the components the embedding stack reads
EMBED_COMPONENTS = ("memory", "neighbors", "mailbox")


def natural_state_view(cfg: MDGNNConfig, state, device=None,
                       components=EMBED_COMPONENTS) -> dict:
    """Natural-layout view of the named components of a sharded state
    (default: those the embedding stack reads; the trackers' view is only
    built when named), on `device` (default shard 0's)."""
    return {name: natural_component_view(cfg, comp, name, device)
            for name, comp in state.items() if name in components}


def natural_memory(cfg: MDGNNConfig, mem: MemoryState,
                   device=None) -> MemoryState:
    return natural_component_view(cfg, mem, "memory", device)


# ---------------------------------------------------------------------------
# Routing plan
# ---------------------------------------------------------------------------


def bucket_plan(owner, valid, n_shards: int, budget: int):
    """Per-occurrence routing plan for the flat (n_shards * budget, ...)
    send buffer.

    Returns (slot, rank, kept, overflow): `rank` is the stable arrival rank
    of each VALID occurrence within its destination lane (array order: a
    stable sort and searchsorted, so padding rows never move a valid row's
    rank); `kept = valid & (rank < budget)`; `slot = owner * budget + rank`
    for kept rows and the drop slot n_shards * budget otherwise;
    `overflow` (an int32 scalar) counts the valid rows the budget masked
    out, so sum(kept) + overflow == sum(valid)."""
    m = owner.shape[0]
    dev = owner.device
    keys = torch.where(valid, owner.long(),
                       torch.full_like(owner.long(), n_shards))
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order]
    start = torch.searchsorted(sorted_keys,
                               torch.arange(n_shards + 1, device=dev))
    rank_sorted = torch.arange(m, device=dev) - start[sorted_keys]
    rank = torch.zeros(m, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    kept = valid & (rank < budget)
    overflow = (valid & (rank >= budget)).sum(dtype=torch.int32)
    slot = torch.where(kept, owner.long() * budget + rank,
                       torch.full_like(rank, n_shards * budget))
    return slot, rank, kept, overflow


def bucket_scatter(x, slot, n_shards: int, budget: int, fill=0):
    """Scatter per-occurrence rows into the flat send buffer (drop-slot
    trick: index n_shards * budget is an extra row, cut off). Out of
    place, so autograd carries `x`'s gradient."""
    buf = torch.full((n_shards * budget + 1,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return buf.index_put((slot,), x)[:-1]


def bucket_gather(flat, owner, rank, budget: int, kept, fill=0):
    """Inverse of bucket_scatter on the return path: occurrence (owner,
    rank)'s row of a flat (n_shards * budget, ...) buffer; rows that were
    never routed (masked or overflowed) read `fill`."""
    idx = torch.clamp(owner.long() * budget + rank, 0, flat.shape[0] - 1)
    out = flat.index_select(0, idx)
    keep = kept.reshape(kept.shape + (1,) * (out.ndim - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=out.dtype,
                                             device=out.device))


# ---------------------------------------------------------------------------
# The sharded MEMORY + PRES stage
# ---------------------------------------------------------------------------


def _padded_occurrences(batch: EventBatch, n_shards: int):
    """node_occurrences padded to a multiple of n_shards (mask=False pads)
    plus each occurrence's global batch position (the selected-flag
    tie-break the owner uses)."""
    nodes, times, other, feat, mask = batching.node_occurrences(batch)
    m = nodes.shape[0]
    m_pad = padded_rows(m, n_shards)

    def pad(x):
        if m_pad == m:
            return x
        return torch.cat([x, torch.zeros((m_pad - m,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device)])

    return (pad(nodes), pad(times), pad(other), pad(feat), pad(mask),
            torch.arange(m_pad, device=nodes.device), m)


def _owner_gather(table, req, me: int, n_shards: int):
    """Answer a replicated natural-id request vector from a local table
    slice: the rows shard `me` owns, zeros elsewhere (float32). The psum of
    the shards' answers is exact (0 + x == x)."""
    own = (req % n_shards) == me
    loc = torch.where(own, req // n_shards, torch.zeros_like(req))
    rows = table.index_select(0, loc).float()
    keep = own.reshape(own.shape + (1,) * (rows.ndim - 1))
    return torch.where(keep, rows, torch.zeros((), device=rows.device))


def _owner_mean(pr: pres.PresState, req, me: int, n_shards: int):
    """`_owner_gather` of the GMM mixture means: the owned tracker rows are
    gathered first and the mean formed on them (the same per-row math as
    JAX's whole-table mean, without reading every row)."""
    own = (req % n_shards) == me
    loc = torch.where(own, req // n_shards, torch.zeros_like(req))
    rows = pres.mixture_mean(pr, loc)
    return torch.where(own[:, None], rows, torch.zeros((), device=rows.device))


def _per_device(mesh, fn, *xs):
    """fn(s, *rows) over each shard's rows, run ONCE per device on the
    rows of all the shards it holds (concatenated in shard order, `s` the
    first of them), then split back per shard: the shards of one card
    share one matrix product, which gives each row what the unsharded
    step's product over all the rows gives it."""
    out = [None] * len(mesh)
    for dev in dict.fromkeys(mesh):
        held = [s for s, d in enumerate(mesh) if d == dev]
        sizes = [xs[0][s].shape[0] for s in held]
        res = fn(held[0], *(torch.cat([x[s] for s in held]) for x in xs))
        for s, part in zip(held, torch.split(res, sizes)):
            out[s] = part
    return out


def _shard_pres(pr: pres.PresState, s: int) -> pres.PresState:
    return pres.PresState(n=pr.n[s], xi=pr.xi[s], psi=pr.psi[s])


def sharded_memory_and_pres(params, cfg: MDGNNConfig, state,
                            prev_batch: EventBatch):
    """loop.memory_and_pres for a sharded state: the same (mem_state, info,
    fused, delta) contract, the memory and trackers sharded and the
    touched rows delivered by the protocol of the module docstring.
    mem_state holds per-shard lists; info and the rows live on the
    controller (the batch's device) and additionally carry
    "route_overflow" (the step's budget-masked valid rows, int32) and
    "route_overflow_shards" ((n_shards,) per sender)."""
    n = cfg.n_shards
    mem, pr = state["memory"], state["pres"]
    mesh = mesh_of(state)
    if len(mesh) != n:
        raise ValueError(f"a state of {len(mesh)} shards for n_shards={n}")
    main = prev_batch.src.device
    n_buckets = cfg.pres_buckets or cfg.n_nodes
    nodes, times, other, feat, mask, pos, m = _padded_occurrences(
        prev_batch, n)
    ms = nodes.shape[0] // n                     # occurrences a shard
    budget = cfg.shard_budget or ms              # default: overflow-free
    use_fused = cfg.use_kernels and cfg.use_pres and cfg.memory_cell == "gru"
    p = replicate(params, mesh)

    def split(x):
        """The sender slices: shard s holds occurrences s*ms .. (s+1)*ms."""
        return [x[s * ms:(s + 1) * ms].to(dev) for s, dev in enumerate(mesh)]

    def mine(rows, s, width):
        return rows[s][s * width:(s + 1) * width]

    nodes_l, times_l, feat_l, mask_l, pos_l = map(
        split, (nodes, times, feat, mask, pos))
    nodes_c = [x.clamp(0, cfg.n_nodes - 1) for x in nodes_l]
    other_c = [x.clamp(0, cfg.n_nodes - 1) for x in split(other)]
    # ---- 1. request gather: pre-update rows of both endpoints ----------
    req = all_gather([torch.cat([a, b]) for a, b in zip(nodes_c, other_c)],
                     mesh)
    rows = psum([_owner_gather(mem.mem[s], req[s], s, n) for s in range(n)],
                mesh)
    s_self = [mine(rows, s, 2 * ms)[:ms] for s in range(n)]
    s_other = [mine(rows, s, 2 * ms)[ms:] for s in range(n)]
    lu_req = all_gather(nodes_c, mesh)
    lu_rows = psum([_owner_gather(mem.last_update[s], lu_req[s], s, n)
                    for s in range(n)], mesh)
    t_prev = [mine(lu_rows, s, ms) for s in range(n)]
    dmean = None
    if cfg.use_pres:
        b_req = all_gather([x % n_buckets for x in nodes_c], mesh)
        d_rows = psum([_owner_mean(_shard_pres(pr, s), b_req[s], s, n)
                       for s in range(n)], mesh)
        dmean = [mine(d_rows, s, ms) for s in range(n)]
    # ---- 2. MESSAGE stage (event-sharded) -------------------------------
    msgs = _per_device(
        mesh, lambda s, ss, so, f, t, tp: modules.message(
            p[s]["msg"], ss, so, f,
            modules.time_encode(p[s]["time"], t - tp)),
        s_self, s_other, feat_l, times_l, t_prev)
    # ---- 3. route to owners: one all_to_all a field -----------------------
    owner = [x % n for x in nodes_c]
    plans = [bucket_plan(owner[s], mask_l[s], n, budget) for s in range(n)]

    def route(xs, fill=0):
        return all_to_all([bucket_scatter(x, plans[s][0], n, budget, fill)
                           for s, x in enumerate(xs)], mesh)

    r_node = route(nodes_c)
    r_valid = route([pl[2] for pl in plans], False)
    r_t = route(times_l)
    r_msg = route(msgs)
    r_pos = route(pos_l)
    r_dmean = route(dmean) if dmean is not None else None
    # ---- 4. owner-local update --------------------------------------------
    new_mem, new_lu, s_meas, fused, delta, sel = [], [], [], [], [], []
    for r in range(n):
        mem_l, lu_l, valid = mem.mem[r], mem.last_update[r], r_valid[r]
        per_node = mem_l.shape[0]
        nb = valid.shape[0]
        loc = torch.clamp(r_node[r] // n, 0, per_node - 1)
        seg = torch.where(valid, loc, torch.full_like(loc, per_node))
        vf = valid.float()
        if cfg.aggregator == "mean":
            summed = torch.zeros((per_node + 1, r_msg[r].shape[1]),
                                 device=vf.device).index_add(
                0, seg, r_msg[r] * vf[:, None])
            cnt = torch.zeros(per_node + 1, device=vf.device).index_add(
                0, seg, vf)
            r_msg[r] = (summed / torch.clamp(cnt[:, None], min=1.0)
                        ).index_select(0, loc)
        # the selected-last flags: the owner holds every routed occurrence
        # of its nodes, and the global batch position breaks time ties as
        # the single-device stable sort does
        node_key = torch.where(valid, loc,
                               torch.full_like(loc, batching.INT32_MAX))
        big_t = torch.where(valid, r_t[r],
                            torch.full_like(r_t[r], -float("inf")))
        order = batching.lexsort((r_pos[r], big_t, node_key))
        nk_s, v_s = node_key[order], valid[order]
        is_last = torch.ones(nb, dtype=torch.bool, device=vf.device)
        is_last[:-1] = (nk_s[1:] != nk_s[:-1]) | ~v_s[1:]
        selected = torch.zeros(nb, dtype=torch.bool, device=vf.device)
        selected[order] = is_last & v_s
        if cfg.pres_scale == "count":
            cnt_n = torch.zeros(per_node + 1, device=vf.device).index_add(
                0, seg, vf)
            scale = cnt_n.index_select(0, loc)
        else:   # "time", read before the update writes last_update
            scale = torch.clamp(r_t[r] - lu_l.index_select(0, loc), min=0.0)
        widx = torch.where(selected, loc, torch.full_like(loc, per_node))
        gamma = torch.sigmoid(p[r]["pres"]["gamma_logit"])
        if use_fused:
            # `order` groups by node with the selected occurrence last, the
            # layout the single-device path hands the kernel
            inv = torch.empty_like(order)
            inv[order] = torch.arange(nb, device=order.device)
            gidx = torch.where(valid, loc, torch.full_like(loc, per_node + 1))
            pm = p[r]["mem"]
            tab, lt, sm, fu, de = kops.memory_update_table(
                mem_l, lu_l, r_msg[r].index_select(0, order),
                gidx[order].to(torch.int32), widx[order].to(torch.int32),
                r_t[r][order], pm["w"], pm["u"], pm["b"],
                r_dmean[r].index_select(0, order), scale[order], gamma,
                clip=cfg.pres_clip, delta_mode=cfg.delta_mode,
                mode=cfg.kernels_mode)
            sm, fu, de = (x.index_select(0, inv) for x in (sm, fu, de))
        else:
            h_prev = mem_l.index_select(0, loc).float()
            sm = mdgnn.memory_cell(cfg, p[r]["mem"], r_msg[r], h_prev)
            if cfg.use_pres:
                s_pred = ref.pres_predict_ref(h_prev, r_dmean[r], scale,
                                              clip=cfg.pres_clip)
                fu = (1.0 - gamma) * s_pred + gamma * sm
                base = s_pred if cfg.delta_mode == "innovation" else h_prev
                de = (fu - base) / torch.clamp(scale, min=1.0)[:, None]
            else:
                fu, de = sm, torch.zeros_like(sm)
            tab = mdgnn.scatter_rows(mem_l, widx, fu)
            lt = mdgnn.scatter_rows(lu_l, widx, r_t[r])
        new_mem.append(tab)
        new_lu.append(lt)
        s_meas.append(sm)
        fused.append(fu)
        delta.append(de)
        sel.append(selected)
    # ---- 5. unroute per-occurrence outputs back to the senders ----------
    def unroute(xs, fill=0.0):
        back = all_to_all(xs, mesh)
        return [bucket_gather(back[s], owner[s], plans[s][1], budget,
                              plans[s][2], fill) for s in range(n)]

    def to_main(xs):
        return all_gather(xs, (main,))[0][:m]

    if cfg.aggregator == "mean":
        # each valid occurrence carries its node's mean message, as the
        # single-device info does (masked rows read 0; nothing reads them)
        msgs = unroute(r_msg)
    overflow = all_gather([pl[3].reshape(1) for pl in plans], (main,))[0]
    info = {"nodes": nodes[:m], "selected": to_main(unroute(sel, False)),
            "mask": mask[:m], "s_prev": to_main(s_self),
            "s_meas": to_main(unroute(s_meas)), "t_prev": to_main(t_prev),
            "t_now": times[:m], "msgs": to_main(msgs),
            "route_overflow": overflow.sum(dtype=torch.int32),
            "route_overflow_shards": overflow}
    return (MemoryState(mem=new_mem, last_update=new_lu), info,
            to_main(unroute(fused)), to_main(unroute(delta)))


# ---------------------------------------------------------------------------
# Sharded non-differentiable state maintenance (in place)
# ---------------------------------------------------------------------------


def sharded_ring_append(cfg: MDGNNConfig, bufs, ptr, nodes, values,
                        mask) -> None:
    """Owner-local ring-buffer append, IN PLACE: every shard sees the full
    occurrence arrays and appends only the rows it owns (ownership folded
    into the mask) at its local ids, its own dump row taking the rest.
    Per-node ranks match the single-device ones: the stable sort keeps the
    relative order of one node's valid occurrences."""
    n = cfg.n_shards
    for s, pt in enumerate(ptr):
        dev = pt.device
        nodes_c = nodes.to(dev).clamp(0, cfg.n_nodes - 1)
        own = (nodes_c % n) == s
        batching.ring_buffer_append(
            {k: v[s] for k, v in bufs.items()}, pt, nodes_c // n,
            {k: v.to(dev) for k, v in values.items()}, mask.to(dev) & own)


def sharded_neighbor_update(cfg: MDGNNConfig, neighbors,
                            batch: EventBatch) -> None:
    nodes, times, other, _, mask = batching.node_occurrences(batch)
    sharded_ring_append(cfg, {"nbr": neighbors["nbr"], "t": neighbors["t"]},
                        neighbors["ptr"], nodes, {"nbr": other, "t": times},
                        mask)


def sharded_mailbox_update(cfg: MDGNNConfig, mailbox, nodes, msgs, times,
                           mask) -> None:
    sharded_ring_append(cfg, {"msg": mailbox["msg"], "t": mailbox["t"]},
                        mailbox["ptr"], nodes, {"msg": msgs, "t": times},
                        mask)


def sharded_tracker_update(cfg: MDGNNConfig, pres_state, track_ids, delta,
                           mask) -> None:
    """Owner-local Eq. 9 tracker update over the sharded trackers, IN
    PLACE. Each shard adds its owned occurrences in array order, as the
    single-device `index_add_` adds them all."""
    n = cfg.n_shards
    n_buckets = cfg.pres_buckets or cfg.n_nodes
    for s in range(n):
        dev = pres_state.n[s].device
        ids_c = track_ids.to(dev).clamp(0, n_buckets - 1)
        own = (ids_c % n) == s
        pres.update_trackers(_shard_pres(pres_state, s), ids_c // n,
                             delta.to(dev), torch.zeros_like(ids_c),
                             mask.to(dev) & own)


def sharded_maintain_state(cfg: MDGNNConfig, params, state2, aux,
                           prev_batch: EventBatch,
                           track_deltas: bool = True) -> None:
    """Sharded counterpart of loop.maintain_state, in place on `state2`:
    the memory shards detached, then the PRES trackers, the neighbour
    rings and APAN's mailbox updated owner-locally from the replicated
    occurrence arrays. APAN's messages are recomputed from a natural view
    of the live memory.

    A shard the table kernel wrote in place is detached in place, as the
    single-device step detaches its table: it is the caller's tensor too,
    and a captured macro step (train/scan.py) hands the caller's carry to
    the next capture. A shard the out-of-place scatter made is a view of
    its padded buffer, which cannot be detached in place; it is new to
    this step, so the state takes a detached copy of it."""
    for shards in (state2["memory"].mem, state2["memory"].last_update):
        for i, t in enumerate(shards):
            shards[i] = t.detach() if t._is_view() else t.detach_()
    if track_deltas and cfg.use_pres:
        nodes = aux["info_nodes"]
        ids = nodes % cfg.pres_buckets if cfg.pres_buckets else nodes
        sharded_tracker_update(cfg, state2["pres"], ids, aux["delta"],
                               aux["info_selected"] & aux["info_mask"])
    sharded_neighbor_update(cfg, state2["neighbors"], prev_batch)
    if cfg.variant == "apan":
        sharded_apan_mailbox(params, cfg, state2, prev_batch)


def sharded_apan_mailbox(params, cfg: MDGNNConfig, state2,
                         batch: EventBatch) -> None:
    """APAN: the batch's messages from a natural view of the live memory,
    appended to the owners' mailboxes, with no gradient."""
    with torch.no_grad():
        view = natural_memory(cfg, state2["memory"], batch.src.device)
        nodes, times, msgs, mask = mdgnn.compute_messages(params, cfg, view,
                                                          batch)
        sharded_mailbox_update(cfg, state2["mailbox"], nodes, msgs, times,
                               mask)
