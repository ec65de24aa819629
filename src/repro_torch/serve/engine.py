"""ServeEngine: device-resident MDGNN online inference (counterpart of
`repro/serve/engine.py`).

The engine keeps the whole runtime state (memory table, neighbour rings,
PRES trackers, APAN's mailbox) on the device and exposes three entry
points:

* `ingest(events)` folds a micro-batch through the memory path
  (`loop.memory_and_pres`: the `memory_update_table` kernel with PRES, the
  `gru_cell` kernel without), then updates the trackers, the rings and
  APAN's mailbox (`loop.maintain_state`), all IN PLACE on the state
  tensors (the JAX engine donates its state buffers for the same effect);
* `query(srcs, dsts, ts)` scores candidate pairs through the variant's
  embedding (TGN: `embed_attn`, or `neighbor_attn` on the dense path;
  JODIE: its time projection, no kernel; APAN: `neighbor_attn`) and the
  link decoder;
* `recommend_topk(srcs, t, k)` scores every source against the full item
  range through the `link_score` kernel and returns the top-k items.

The kernels named run with cfg.use_kernels; without it every call takes
the reference's plain route (the plain cell and filter, the plain
attention, `ref.link_score_ref`) and launches no kernel.

Requests are padded to the batcher's buckets, so each body runs at a
bounded set of shapes. A body runs on static input tensors per bucket
(per bucket and k for top-k); the host API copies each padded request
into them. The first call of a key prepares it (`trace_counts[key] += 1`,
keyed as JAX keys its traces): on CUDA it runs the body once eagerly on a
side stream (kernel builds, allocator growth; an ingest on a fully masked
batch, which leaves the state's rows as they were) and captures it as a
CUDA graph, replayed from then on, the port's counterpart of the JAX
engine's program compiled once per bucket; all graphs share one memory
pool. `warmup()` prepares every bucket. Query and top-k are captured for
every config (`captured_bodies`). Ingest is captured only where the fold
waits for nothing on the host: where the memory stage is the
`memory_update_table` kernel (PRES, the GRU cell and kernels: TGN, dense
TGN, APAN and JODIE). The other folds (the rnn cell, no PRES, the plain
route) go through `mdgnn.memory_update`, whose `torch.nonzero` waits for
the device (ROADMAP P10/P20), and run eagerly on the same static buffers.
`capture=False` runs every body eagerly; the CPU never captures.

A captured graph writes into the storage the state and parameter tensors
held at capture, so once a graph exists `state` and `params` cannot be
re-bound (the setter raises); every update is in place. A replay calls
no kernel wrapper, so the engine adds each graph's launches, counted at
capture, to the launch counters at every replay (`ops.add_launches`).

Each body runs inside a `torch.profiler.record_function` range
(serve_ingest, serve_query, serve_topk). The engine runs on CUDA unless
`device="cpu"` is passed; then every kernel takes its plain PyTorch
version."""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import io as checkpoint_io
from repro_torch.device import resolve_device
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.train import loop as loop_lib

CPU = torch.device("cpu")


def captured_bodies(cfg: MDGNNConfig) -> frozenset:
    """The bodies an engine captures as CUDA graphs on a CUDA device:
    "query" and "topk" always, "ingest" where the fold's memory stage is
    the `memory_update_table` kernel (PRES, the GRU cell, kernels that
    launch), whose fold has no host sync."""
    bodies = {"query", "topk"}
    if (cfg.use_kernels and cfg.use_pres and cfg.memory_cell == "gru"
            and cfg.kernels_mode != "oracle"):
        bodies.add("ingest")
    return frozenset(bodies)


@dataclasses.dataclass
class _Slot:
    """One prepared key: its static inputs, the body on them and, once
    captured, the graph, its static outputs and its launch census."""
    inputs: tuple
    run: Callable[[], Any]
    graph: Any = None
    outputs: Any = None
    census: dict = dataclasses.field(default_factory=dict)


class ServeEngine:
    """Online MDGNN inference over a device-resident memory state.

    `track_deltas=True` keeps updating the PRES trackers from serve-time
    deltas; False freezes them (the offline-parity mode). `params` and
    `state` must already live on the engine's device (mdgnn.init_params /
    init_state, the bridge, or `from_checkpoint`). `capture=False` runs
    the bodies eagerly on CUDA too."""

    def __init__(self, cfg: MDGNNConfig, params, state, *,
                 track_deltas: bool = True,
                 batcher: MicroBatcher | None = None,
                 item_range: tuple[int, int] | None = None, device=None,
                 capture: bool = True):
        mdgnn.check_supported(cfg)
        self.device = resolve_device(device)
        mem = state["memory"].mem
        if mem.device != self.device:
            raise ValueError(f"state lives on {mem.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self._params = params
        self._state = state
        self.track_deltas = track_deltas
        self.batcher = batcher or MicroBatcher(d_edge=cfg.d_edge)
        self.item_range = item_range
        self.capture = capture and self.device.type == "cuda"
        self.trace_counts: collections.Counter = collections.Counter()
        self._slots: dict[tuple, _Slot] = {}
        self._pool = None

    @classmethod
    def from_checkpoint(cls, path: str, cfg: MDGNNConfig, *, seed: int = 0,
                        device=None, **kw) -> "ServeEngine":
        """Restore a training checkpoint (the {"params", "state"} bundle of
        the train CLI's --checkpoint, or of the JAX package's) into a live
        engine. `cfg` must match the training config: the leaf count, the
        tree structure and every leaf's shape are checked before anything
        reaches the device, and a mismatch raises ValueError."""
        dev = resolve_device(device)
        meta = torch.device("meta")
        like = bridge.mdgnn_bundle(
            mdgnn.init_params(cfg, torch.Generator().manual_seed(seed), meta),
            mdgnn.init_state(cfg, meta))
        params, state = bridge.mdgnn_bundle_from_numpy(
            checkpoint_io.read_checkpoint(path, like), dev)
        return cls(cfg, params, state, device=dev, **kw)

    # ------------------------------------------------------------------ #
    # state and parameters: re-bound only while no graph holds them
    # ------------------------------------------------------------------ #

    def _rebind(self, what: str) -> None:
        if any(s.graph is not None for s in self._slots.values()):
            raise RuntimeError(
                f"this engine has captured CUDA graphs, which write into the "
                f"storage its {what} held at capture; update the {what} in "
                f"place, or build another engine")

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value) -> None:
        self._rebind("state")
        self._state = value

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value) -> None:
        self._rebind("params")
        self._params = value

    # ------------------------------------------------------------------ #
    # device bodies
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _ingest_body(self, batch: EventBatch) -> None:
        with torch.profiler.record_function("serve_ingest"):
            _, info, _, delta = loop_lib.memory_and_pres(
                self.params, self.cfg, self.state, batch)
            aux = {"delta": delta, "info_nodes": info["nodes"],
                   "info_selected": info["selected"],
                   "info_mask": info["mask"]}
            loop_lib.maintain_state(self.cfg, self.params, self.state, aux,
                                    batch, track_deltas=self.track_deltas)

    @torch.no_grad()
    def _query_body(self, src, dst, t):
        with torch.profiler.record_function("serve_query"):
            b = src.shape[0]
            h = mdgnn.embed_nodes(self.params, self.cfg, self.state,
                                  torch.cat([src, dst]), torch.cat([t, t]))
            return mdgnn.link_logits(self.params, h[:b], h[b:])

    @torch.no_grad()
    def _topk_body(self, src, t, k: int):
        with torch.profiler.record_function("serve_topk"):
            lo, hi = self.item_range
            items = torch.arange(lo, hi, dtype=torch.int64, device=src.device)
            # item embeddings are shared by the batch, taken at its latest
            # timestamp
            t_item = t.max().expand(hi - lo)
            h = mdgnn.embed_nodes(self.params, self.cfg, self.state,
                                  torch.cat([src, items]),
                                  torch.cat([t, t_item]))
            h_src, h_items = h[:src.shape[0]], h[src.shape[0]:]
            dec = self.params["dec"]
            if self.cfg.use_kernels:
                scores = kops.link_score(h_src, h_items, dec["w1"],
                                         dec["b1"], dec["w2"], dec["b2"],
                                         mode=self.cfg.kernels_mode)
            else:
                scores = ref.link_score_ref(h_src, h_items, dec["w1"],
                                            dec["b1"], dec["w2"], dec["b2"])
            vals, idx = torch.topk(scores, k, dim=1)
            return vals, idx + lo

    # ------------------------------------------------------------------ #
    # static buffers and graphs per key
    # ------------------------------------------------------------------ #

    def _body(self, key: tuple, inputs: tuple) -> Callable[[], Any]:
        if key[0] == "ingest":
            return lambda: self._ingest_body(EventBatch(*inputs))
        if key[0] == "query":
            return lambda: self._query_body(*inputs)
        return lambda: self._topk_body(*inputs, key[2])

    def _prepare(self, key: tuple, host: tuple) -> _Slot:
        """Static inputs of the host tensors' shapes and dtypes, zeroed (an
        ingest's mask all False), and on CUDA the body captured."""
        inputs = tuple(torch.zeros(x.shape, dtype=x.dtype, device=self.device)
                       for x in host)
        slot = _Slot(inputs, self._body(key, inputs))
        if self.capture and key[0] in captured_bodies(self.cfg):
            self._capture(slot)
        self._slots[key] = slot
        self.trace_counts[key] += 1
        return slot

    def _capture(self, slot: _Slot) -> None:
        """Run the body once eagerly on a side stream (the zeroed inputs: a
        masked ingest changes no row of the state), then capture it. The
        wrappers count their launches while the body is captured, when no
        kernel runs: that count is the graph's census, taken back here and
        added at every replay."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            slot.run()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kops.launch_census()
        with torch.cuda.graph(graph, pool=self._pool):
            slot.outputs = slot.run()
        slot.census = kops.launches_since(before)
        kops.add_launches(slot.census, -1)
        slot.graph = graph

    def _call(self, key: tuple, *host):
        """Copy the host tensors into the key's static inputs and run its
        body (a graph replay where captured). The outputs are the graph's
        static tensors, overwritten by the next replay: read them at once."""
        slot = self._slots.get(key) or self._prepare(key, host)
        for buf, x in zip(slot.inputs, host):
            buf.copy_(x)
        if slot.graph is None:
            return slot.run()
        slot.graph.replay()
        kops.add_launches(slot.census)
        return slot.outputs

    def _fold(self, eb: EventBatch) -> None:
        """One fold of a bucket-padded batch on the host (the per-fold
        entry point of `ingest`)."""
        self._call(("ingest", eb.src.shape[0]), eb.src, eb.dst, eb.t,
                   eb.feat, eb.mask)

    # ------------------------------------------------------------------ #
    # host API (micro-batched: pad-to-bucket, split-over-max)
    # ------------------------------------------------------------------ #

    def ingest(self, src, dst, t, feat=None) -> int:
        """Fold a request of events (chronological within the request) into
        the memory. Returns the number of events folded."""
        n = len(np.asarray(src))
        for eb in self.batcher.pad_events(src, dst, t, feat, device=CPU):
            self._fold(eb)
        return n

    def query(self, src, dst, t) -> np.ndarray:
        """Link scores for candidate (src, dst) pairs at query times `t`."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        t = np.asarray(t, np.float32)
        n = len(src)
        if n == 0:
            return np.zeros((0,), np.float32)
        out = []
        for lo, hi in self.batcher.chunk_spans(n):
            s, d, tt, valid = self.batcher.pad_query(
                src[lo:hi], dst[lo:hi], t[lo:hi], device=CPU)
            scores = self._call(("query", s.shape[0]), s, d, tt)
            out.append(scores[:valid].cpu().numpy())
        return np.concatenate(out)

    def recommend_topk(self, src, t, k: int):
        """Top-k items per source against the full item range. Returns
        (scores (B, k), item_ids (B, k)) as numpy arrays."""
        if self.item_range is None:
            raise ValueError("recommend_topk needs the engine constructed "
                             "with item_range=(item_lo, item_hi)")
        src = np.asarray(src, np.int32)
        t = np.asarray(t, np.float32)
        n_items = self.item_range[1] - self.item_range[0]
        if not 0 < k <= n_items:
            raise ValueError(f"k must be in [1, {n_items}], got {k}")
        vals_out, ids_out = [], []
        for lo, hi in self.batcher.chunk_spans(len(src)):
            s, _, tt, valid = self.batcher.pad_query(
                src[lo:hi], np.zeros(hi - lo, np.int32), t[lo:hi],
                device=CPU)
            vals, ids = self._call(("topk", s.shape[0], k), s, tt)
            vals_out.append(vals[:valid].cpu().numpy())
            ids_out.append(ids[:valid].to(torch.int32).cpu().numpy())
        return np.concatenate(vals_out), np.concatenate(ids_out)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def warmup(self, *, query: bool = True, topk_k: int | None = None) -> None:
        """Prepare every bucket (on CUDA: capture its graphs) and run it
        once on a fully masked no-op batch and zero queries, so the first
        live request pays no capture, no kernel build and no allocator
        growth. Every write of a masked fold goes to a dump row or is
        skipped, so the state's rows [:N] stay bit-identical."""
        if topk_k is not None and self.item_range is None:
            raise ValueError("warmup(topk_k=...) needs the engine "
                             "constructed with item_range=(item_lo, item_hi)")
        d_edge = self.batcher.d_edge
        # a capture empties the allocator's cache, so with graphs every
        # bucket runs once more after the last one: the eager bodies' blocks
        # are then cached for live traffic
        for _ in range(2 if self.capture else 1):
            for b in self.batcher.buckets:
                z = np.zeros(b, np.int32)
                zf = np.zeros(b, np.float32)
                self._fold(EventBatch.from_numpy(
                    z, z, zf, np.zeros((b, d_edge), np.float32),
                    np.zeros(b, bool), CPU))
                zi = torch.zeros(b, dtype=torch.int64)
                zt = torch.zeros(b, dtype=torch.float32)
                if query:
                    self._call(("query", b), zi, zi, zt)
                if topk_k is not None:
                    self._call(("topk", b, topk_k), zi, zt)
        self.block_until_ready()

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
