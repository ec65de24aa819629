"""On-disk memory-mapped event store (counterpart of
`repro/graph/store.py`; the same format byte for byte, so a store written
by either package opens in the other).

Layout - a directory holding a JSON header plus one file per column:

    <store>/header.json   {"magic", "version", "n_events", "num_nodes",
                           "feat_dim", "meta": {...}}
    <store>/src.bin       n_events x int32    (little-endian)
    <store>/dst.bin       n_events x int32
    <store>/t.bin         n_events x float32
    <store>/feat.bin      n_events x float32[F]   (row-major)

Each column has a fixed stride, so events [lo, hi) of a column map with
one `np.memmap` and the view is contiguous: batches are carved from it as
from the in-RAM arrays. Only one bounded window is mapped while a
`StoreStream` iterates, so resident memory stays flat as the stream
grows. Appends in any chunking give byte-identical files, and a
`StoreStream`'s batches are bit-identical to the in-RAM carve for every
window size. Windows are the host span "store_window" (obs.trace)."""
from __future__ import annotations

import json
import pathlib

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graph.events import EventStream
from repro_torch.obs import trace as obs_trace

MAGIC = "repro-evstore"
VERSION = 1
HEADER_NAME = "header.json"
# column name -> (file name, dtype); feat's row width is the header's
# feat_dim (its per-event stride is 4*feat_dim bytes)
COLUMNS = {"src": ("src.bin", "<i4"), "dst": ("dst.bin", "<i4"),
           "t": ("t.bin", "<f4"), "feat": ("feat.bin", "<f4")}
# default mapped-window length for streamed iteration: ~5 MB of records at
# feat_dim 16 - large enough that the per-window mmap/unmap cost amortises
# over dozens of batches, small enough that resident pages stay bounded
# and flat even for small streams
DEFAULT_WINDOW = 1 << 16


def check_feat_dim(feat_dim: int) -> int:
    if feat_dim < 1:
        raise ValueError(f"feat_dim must be >= 1, got {feat_dim} - "
                         "featureless streams store a zero column "
                         "(matching the in-RAM loaders)")
    return int(feat_dim)


class StoreWriter:
    """Append-only event-store writer (chunked, bounded memory).

    Column chunks are written file-per-column; the header (with the final
    event count) lands on `close()`. The file bytes depend only on the
    event sequence, never on the append chunking - the generator- and
    converter-side half of the chunk-boundary parity guarantee. Use as a
    context manager:

        with StoreWriter(path, num_nodes=n, feat_dim=f) as w:
            w.append(src, dst, t, feat)   # any number of chunks
    """

    def __init__(self, path, num_nodes: int, feat_dim: int,
                 meta: dict | None = None):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.num_nodes = int(num_nodes)
        self.feat_dim = check_feat_dim(feat_dim)
        self.meta = dict(meta or {})
        self._files = {c: open(self.path / name, "wb")
                       for c, (name, _) in COLUMNS.items()}
        self.n_events = 0
        self._last_t = -np.inf
        self._closed = False

    def append(self, src, dst, t, feat) -> None:
        """Append one chunk of chronologically ordered events."""
        src = np.ascontiguousarray(src, "<i4")
        dst = np.ascontiguousarray(dst, "<i4")
        t = np.ascontiguousarray(t, "<f4")  # stored precision - compare in it
        feat = np.ascontiguousarray(feat, "<f4")
        n = len(src)
        if n == 0:
            return
        if not (len(dst) == len(t) == len(feat) == n):
            raise ValueError(f"ragged chunk: src={n} dst={len(dst)} "
                             f"t={len(t)} feat={len(feat)}")
        if feat.ndim != 2 or feat.shape[1] != self.feat_dim:
            raise ValueError(f"feat must be ({n}, {self.feat_dim}), "
                             f"got {feat.shape}")
        hi = int(max(src.max(), dst.max()))
        if int(src.min()) < 0 or hi >= self.num_nodes:
            raise ValueError("event endpoints outside [0, num_nodes)")
        if float(t[0]) < self._last_t or np.any(np.diff(t) < 0):
            raise ValueError("events must be appended in chronological "
                             "order (non-decreasing float32 timestamps "
                             "across chunks)")
        for col, arr in (("src", src), ("dst", dst), ("t", t), ("feat", feat)):
            arr.tofile(self._files[col])
        self.n_events += n
        self._last_t = float(t[-1])

    def close(self) -> "EventStore":
        if self._closed:
            return EventStore.open(self.path)
        for f in self._files.values():
            f.close()
        self._closed = True
        header = {"magic": MAGIC, "version": VERSION,
                  "n_events": self.n_events, "num_nodes": self.num_nodes,
                  "feat_dim": self.feat_dim, "meta": self.meta}
        (self.path / HEADER_NAME).write_text(json.dumps(header, indent=2))
        return EventStore.open(self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:                      # don't mask the error with a half-header
            for f in self._files.values():
                f.close()
            self._closed = True
        return False


class EventStore:
    """Read side: header + on-demand windowed column memmaps."""

    def __init__(self, path, header: dict):
        self.path = pathlib.Path(path)
        self.n_events = int(header["n_events"])
        self.num_nodes = int(header["num_nodes"])
        self.feat_dim = check_feat_dim(header["feat_dim"])
        self.meta = dict(header.get("meta") or {})
        for col, (name, dtype) in COLUMNS.items():
            width = self.feat_dim if col == "feat" else 1
            size = (self.path / name).stat().st_size
            want = self.n_events * np.dtype(dtype).itemsize * width
            if size != want:
                raise ValueError(
                    f"{self.path / name}: {size} bytes but header promises "
                    f"{want} - truncated or mismatched store")

    @classmethod
    def open(cls, path) -> "EventStore":
        path = pathlib.Path(path)
        hpath = path / HEADER_NAME
        if not hpath.exists():
            raise FileNotFoundError(
                f"{path} is not an event store (no {HEADER_NAME}) - create "
                "one with python -m repro_torch.launch.convert_events")
        header = json.loads(hpath.read_text())
        if header.get("magic") != MAGIC:
            raise ValueError(f"{hpath}: bad magic {header.get('magic')!r}")
        if header.get("version") != VERSION:
            raise ValueError(f"{hpath}: unsupported store version "
                             f"{header.get('version')} (reader speaks "
                             f"{VERSION})")
        return cls(path, header)

    @property
    def stride(self) -> int:
        """Total bytes per event across the columns (12 + 4*feat_dim)."""
        return 12 + 4 * self.feat_dim

    @property
    def nbytes(self) -> int:
        return self.n_events * self.stride

    def map_column(self, col: str, lo: int = 0,
                   hi: int | None = None) -> np.ndarray:
        """Read-only contiguous memmap over events [lo, hi) of one column
        - a fresh mapping per call, so dropping the returned array unmaps
        the pages (the RSS bound of the streamed path)."""
        hi = self.n_events if hi is None else hi
        if not 0 <= lo <= hi <= self.n_events:
            raise IndexError(f"window [{lo}, {hi}) outside "
                             f"[0, {self.n_events})")
        name, dtype = COLUMNS[col]
        width = self.feat_dim if col == "feat" else 1
        shape = (hi - lo, width) if col == "feat" else (hi - lo,)
        if lo == hi:               # np.memmap rejects zero-length mappings
            return np.empty(shape, dtype)
        return np.memmap(self.path / name, dtype=dtype, mode="r",
                         offset=lo * np.dtype(dtype).itemsize * width,
                         shape=shape)

    def window(self, lo: int, hi: int | None = None) -> EventStream:
        """Zero-copy in-RAM-contract view of [lo, hi): an `EventStream`
        whose columns are fresh contiguous memmaps."""
        with obs_trace.span("store_window"):
            return EventStream(self.map_column("src", lo, hi),
                               self.map_column("dst", lo, hi),
                               self.map_column("t", lo, hi),
                               self.map_column("feat", lo, hi),
                               self.num_nodes)

    def stream(self, window_events: int = DEFAULT_WINDOW) -> "StoreStream":
        """The full stream behind the `EventStream` contract, iterated
        through bounded mapped windows."""
        return StoreStream(self, window_events=window_events)

    def dst_range(self) -> tuple[int, int]:
        """Negative-sampling destination range: the bipartite item band
        when the writer recorded `n_users`/`n_items` meta (the synthetic
        generators and the JODIE converter do), else all nodes."""
        if "n_users" in self.meta and "n_items" in self.meta:
            lo = int(self.meta["n_users"])
            return lo, lo + int(self.meta["n_items"])
        return 0, self.num_nodes


class StoreStream(EventStream):
    """`EventStream` contract over an on-disk window [lo, hi) of a store.

    Slicing (`slice` / `chronological_split` / `train_serve_split`) just
    narrows the [lo, hi) bounds - nothing is read. Batch iteration maps
    one `window_events`-sized column window at a time (rounded down to a
    whole number of batches so every yielded batch is byte-identical to
    the in-RAM path regardless of window size), delegates to the in-RAM
    `iter_temporal_batches` over that zero-copy contiguous view, then
    drops the mapping - resident pages stay bounded by one window.

    Column access (`.src`, `.dst`, `.t`, `.feat`) maps the whole [lo, hi)
    range once, lazily - zero-copy but page-cache resident as touched; use
    it for bounded tails (the serving replay does), not full-stream scans.
    """

    def __init__(self, store: EventStore, lo: int = 0, hi: int | None = None,
                 window_events: int = DEFAULT_WINDOW):
        hi = store.n_events if hi is None else hi
        if not 0 <= lo <= hi <= store.n_events:
            raise IndexError(f"stream window [{lo}, {hi}) outside "
                             f"[0, {store.n_events})")
        if window_events < 1:
            raise ValueError(f"window_events must be >= 1, "
                             f"got {window_events}")
        self.store = store
        self.lo = lo
        self.hi = hi
        self.window_events = window_events
        self.num_nodes = store.num_nodes
        self._cols = {}

    def __len__(self) -> int:
        return self.hi - self.lo

    @property
    def feat_dim(self) -> int:
        return self.store.feat_dim

    def _col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            self._cols[name] = self.store.map_column(name, self.lo, self.hi)
        return self._cols[name]

    @property
    def src(self) -> np.ndarray:
        return self._col("src")

    @property
    def dst(self) -> np.ndarray:
        return self._col("dst")

    @property
    def t(self) -> np.ndarray:
        return self._col("t")

    @property
    def feat(self) -> np.ndarray:
        return self._col("feat")

    def slice(self, lo: int, hi: int) -> "StoreStream":
        n = len(self)
        lo = min(max(lo, 0), n)       # numpy-slice clamping, like the in-RAM
        hi = min(max(hi, lo), n)      # path's a[lo:hi]
        return StoreStream(self.store, self.lo + lo, self.lo + hi,
                           self.window_events)

    def iter_temporal_batches(self, batch_size: int, device=None):
        # whole batches per window: every batch then comes from exactly one
        # window and matches the in-RAM carve bit for bit; the only padded
        # batch is the stream's own tail, as in the in-RAM path
        dev = resolve_device(device)
        win = max(batch_size,
                  self.window_events // batch_size * batch_size)
        for wlo in range(self.lo, self.hi, win):
            view = self.store.window(wlo, min(wlo + win, self.hi))
            yield from view.iter_temporal_batches(batch_size, dev)
            del view               # unmap before the next window maps

    def materialize(self, chunk_events: int = DEFAULT_WINDOW) -> EventStream:
        """Copy this window into a plain in-RAM `EventStream` (the
        comparison baseline of the parity tests). Copies in
        bounded chunks so peak RSS is the result + one window, not 2x."""
        n = len(self)
        src = np.empty(n, np.int32)
        dst = np.empty(n, np.int32)
        t = np.empty(n, np.float32)
        feat = np.empty((n, self.feat_dim), np.float32)
        for lo in range(0, n, chunk_events):
            hi = min(lo + chunk_events, n)
            view = self.store.window(self.lo + lo, self.lo + hi)
            src[lo:hi] = view.src
            dst[lo:hi] = view.dst
            t[lo:hi] = view.t
            feat[lo:hi] = view.feat
            del view
        return EventStream(src, dst, t, feat, self.num_nodes)


def write_stream(stream: EventStream, path, chunk_events: int = DEFAULT_WINDOW,
                 meta: dict | None = None) -> EventStore:
    """Convert any `EventStream` (in-RAM or another store's view) into an
    on-disk store, `chunk_events` records at a time."""
    with StoreWriter(path, num_nodes=stream.num_nodes,
                     feat_dim=stream.feat_dim, meta=meta) as w:
        for lo in range(0, len(stream), chunk_events):
            hi = min(lo + chunk_events, len(stream))
            w.append(stream.src[lo:hi], stream.dst[lo:hi],
                     stream.t[lo:hi], stream.feat[lo:hi])
    return EventStore.open(path)
