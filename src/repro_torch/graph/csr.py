"""Chunked CSR neighbour index (counterpart of `repro/graph/csr.py`;
the same files byte for byte).

The training-time neighbour state is a fixed-K ring buffer updated online
(core/batching.py); this index answers the static question "all
interactions of node v, in order" for graphs whose adjacency does not fit
one pass of RAM. It builds the CSR triplet

    indptr   (N+1,) int64   - node v's slots are [indptr[v], indptr[v+1])
    nbr      (nnz,) int32   - the other endpoint of each interaction
    ts       (nnz,) float32 - the event timestamp
    eid      (nnz,) int64   - index into the event store (its features)

from an event source in two bounded-memory passes over fixed-size chunks
(count degrees, then cursor-scatter), into `np.memmap` files when a path
is given: peak memory is O(num_nodes) counters plus one chunk. Every
event contributes both directions, and a node's slots are in stream
order. The build is chunk-size invariant byte for byte."""
from __future__ import annotations

import json
import pathlib

import numpy as np

CSR_MAGIC = "repro-evcsr"
CSR_VERSION = 1
HEADER_NAME = "csr.json"
FILES = {"indptr": ("indptr.bin", np.int64),
         "nbr": ("nbr.bin", np.int32),
         "ts": ("ts.bin", np.float32),
         "eid": ("eid.bin", np.int64)}
DEFAULT_CHUNK = 1 << 20


def _chunks(stream, chunk_events: int):
    """Yield (lo, src, dst, t) chunk copies over an EventStream/StoreStream
    without materializing it - slicing a StoreStream maps only the chunk's
    records, and the mapping drops when the view goes out of scope."""
    for lo in range(0, len(stream), chunk_events):
        view = stream.slice(lo, min(lo + chunk_events, len(stream)))
        yield lo, np.asarray(view.src), np.asarray(view.dst), \
            np.asarray(view.t)
        del view


def _occurrence_rank(nodes: np.ndarray) -> np.ndarray:
    """Per-element rank among equal values, in array order (vectorized)."""
    order = np.argsort(nodes, kind="stable")
    sorted_nodes = nodes[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_nodes)) + 1]
    sizes = np.diff(np.r_[starts, len(nodes)])
    rank_sorted = np.arange(len(nodes), dtype=np.int64) \
        - np.repeat(starts, sizes)
    rank = np.empty(len(nodes), np.int64)
    rank[order] = rank_sorted
    return rank


class CSRIndex:
    """Read side over the four CSR arrays (memmapped or in-RAM)."""

    def __init__(self, indptr, nbr, ts, eid, path=None):
        self.indptr = indptr
        self.nbr = nbr
        self.ts = ts
        self.eid = eid
        self.path = path
        self.n_nodes = len(indptr) - 1
        self.nnz = int(indptr[-1])

    @classmethod
    def open(cls, path) -> "CSRIndex":
        path = pathlib.Path(path)
        header = json.loads((path / HEADER_NAME).read_text())
        if header.get("magic") != CSR_MAGIC:
            raise ValueError(f"{path}: bad magic {header.get('magic')!r}")
        if header.get("version") != CSR_VERSION:
            raise ValueError(f"{path}: unsupported csr version "
                             f"{header.get('version')}")
        arrays = {}
        for key, (name, dtype) in FILES.items():
            n = header["n_nodes"] + 1 if key == "indptr" else header["nnz"]
            arrays[key] = (np.memmap(path / name, dtype=dtype, mode="r",
                                     shape=(n,))
                           if n else np.empty(0, dtype))
        return cls(arrays["indptr"], arrays["nbr"], arrays["ts"],
                   arrays["eid"], path=path)

    def degree(self, node: int) -> int:
        return int(self.indptr[node + 1] - self.indptr[node])

    def neighbors(self, node: int):
        """All interactions of `node` in chronological order - zero-copy
        views (nbr, ts, eid)."""
        lo, hi = int(self.indptr[node]), int(self.indptr[node + 1])
        return self.nbr[lo:hi], self.ts[lo:hi], self.eid[lo:hi]

    def recent(self, node: int, k: int):
        """The last-k interactions (the ring buffer's steady-state answer,
        from the static index)."""
        lo, hi = int(self.indptr[node]), int(self.indptr[node + 1])
        lo = max(lo, hi - k)
        return self.nbr[lo:hi], self.ts[lo:hi], self.eid[lo:hi]


def build_csr(source, path=None,
              chunk_events: int = DEFAULT_CHUNK) -> CSRIndex:
    """Two-pass chunked CSR build over an `EventStream`/`EventStore`.

    With `path` the nbr/ts/eid arrays are written as memmapped files (the
    tens-of-millions-of-nodes shape); without, plain in-RAM arrays (tests,
    small graphs). Undirected: event (u, v, t) at stream index e lands as
    (v, t, e) in u's slots and (u, t, e) in v's."""
    stream = source.stream() if hasattr(source, "stream") else source
    n = stream.num_nodes
    # pass 1 - degrees (both endpoints of every event)
    counts = np.zeros(n, np.int64)
    for _, src, dst, _ in _chunks(stream, chunk_events):
        counts += np.bincount(src, minlength=n).astype(np.int64)
        counts += np.bincount(dst, minlength=n).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nnz = int(indptr[-1])
    if path is not None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        mk = lambda key: np.memmap(path / FILES[key][0], dtype=FILES[key][1],
                                   mode="w+", shape=(nnz,)) \
            if nnz else np.empty(0, FILES[key][1])
        nbr, ts, eid = mk("nbr"), mk("ts"), mk("eid")
    else:
        nbr = np.empty(nnz, np.int32)
        ts = np.empty(nnz, np.float32)
        eid = np.empty(nnz, np.int64)
    # pass 2 - cursor scatter; src/dst occurrences interleaved per event so
    # a node's slots keep exact stream order even when it is source of one
    # event and destination of the next within the same chunk
    cursor = indptr[:-1].copy()
    for lo, src, dst, t in _chunks(stream, chunk_events):
        m = len(src)
        a = np.empty(2 * m, np.int64)      # the indexed endpoint
        b = np.empty(2 * m, np.int32)      # the stored neighbour
        a[0::2], a[1::2] = src, dst
        b[0::2], b[1::2] = dst, src
        tt = np.repeat(t.astype(np.float32), 2)
        ee = np.repeat(np.arange(lo, lo + m, dtype=np.int64), 2)
        slot = cursor[a] + _occurrence_rank(a)
        nbr[slot] = b
        ts[slot] = tt
        eid[slot] = ee
        cursor += np.bincount(a, minlength=n).astype(np.int64)
    assert np.array_equal(cursor, indptr[1:]), "CSR fill incomplete"
    if path is not None:
        for arr in (nbr, ts, eid):
            if isinstance(arr, np.memmap):
                arr.flush()
        ip = np.memmap(path / FILES["indptr"][0], dtype=np.int64, mode="w+",
                       shape=(n + 1,))
        ip[:] = indptr
        ip.flush()
        (path / HEADER_NAME).write_text(json.dumps(
            {"magic": CSR_MAGIC, "version": CSR_VERSION, "n_nodes": n,
             "nnz": nnz}, indent=2))
        return CSRIndex.open(path)
    return CSRIndex(indptr, nbr, ts, eid)
