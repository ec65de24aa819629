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

Each runs inside a `torch.profiler.record_function` range (serve_ingest,
serve_query, serve_topk). The engine runs on CUDA unless `device="cpu"` is
passed; then every kernel takes its plain PyTorch version."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.train import loop as loop_lib


class ServeEngine:
    """Online MDGNN inference over a device-resident memory state.

    `track_deltas=True` keeps updating the PRES trackers from serve-time
    deltas; False freezes them. `params` and `state` must already live on
    the engine's device (mdgnn.init_params / init_state, or the bridge)."""

    def __init__(self, cfg: MDGNNConfig, params, state, *,
                 track_deltas: bool = True,
                 batcher: MicroBatcher | None = None,
                 item_range: tuple[int, int] | None = None, device=None):
        mdgnn.check_supported(cfg)
        self.device = resolve_device(device)
        mem = state["memory"].mem
        if mem.device != self.device:
            raise ValueError(f"state lives on {mem.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.state = state
        self.track_deltas = track_deltas
        self.batcher = batcher or MicroBatcher(d_edge=cfg.d_edge)
        self.item_range = item_range

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
    # host API (micro-batched: pad-to-bucket, split-over-max)
    # ------------------------------------------------------------------ #

    def ingest(self, src, dst, t, feat=None) -> int:
        """Fold a request of events (chronological within the request) into
        the memory. Returns the number of events folded."""
        n = len(np.asarray(src))
        for eb in self.batcher.pad_events(src, dst, t, feat,
                                          device=self.device):
            self._ingest_body(eb)
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
                src[lo:hi], dst[lo:hi], t[lo:hi], device=self.device)
            out.append(self._query_body(s, d, tt)[:valid].cpu().numpy())
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
                device=self.device)
            vals, ids = self._topk_body(s, tt, k)
            vals_out.append(vals[:valid].cpu().numpy())
            ids_out.append(ids[:valid].to(torch.int32).cpu().numpy())
        return np.concatenate(vals_out), np.concatenate(ids_out)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def warmup(self, *, query: bool = True, topk_k: int | None = None) -> None:
        """Run every bucket once with fully masked no-op batches, so the
        first live request pays no kernel build, no CUDA context set-up and
        no allocator growth. Every write of a masked fold goes to a dump row
        or is skipped, so the state's rows [:N] stay bit-identical."""
        if topk_k is not None and self.item_range is None:
            raise ValueError("warmup(topk_k=...) needs the engine "
                             "constructed with item_range=(item_lo, item_hi)")
        d_edge = self.batcher.d_edge
        for b in self.batcher.buckets:
            z = np.zeros(b, np.int32)
            zf = np.zeros(b, np.float32)
            self._ingest_body(EventBatch.from_numpy(
                z, z, zf, np.zeros((b, d_edge), np.float32),
                np.zeros(b, bool), self.device))
            zi = torch.zeros(b, dtype=torch.int64, device=self.device)
            zt = torch.zeros(b, dtype=torch.float32, device=self.device)
            if query:
                self._query_body(zi, zi, zt)
            if topk_k is not None:
                self._topk_body(zi, zt, topk_k)
        self.block_until_ready()

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
