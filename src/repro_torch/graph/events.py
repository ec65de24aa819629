"""Event-based dynamic graph representation (counterpart of
`repro/graph/events.py`): `EventBatch` holds one padded temporal batch as
tensors, `EventStream` the host-side chronological stream as numpy arrays
(with the chronological split, the temporal-batch carve of training and
its background-thread prefetch), the loader of the public JODIE CSV
format, plus the serving replay's arrival-clock helpers (numpy copies)."""
from __future__ import annotations

import dataclasses
import queue
import threading
import weakref
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """One temporal batch of events; `mask` is False on padding rows."""
    src: torch.Tensor      # (b,) int64
    dst: torch.Tensor      # (b,) int64
    t: torch.Tensor        # (b,) float32
    feat: torch.Tensor     # (b, F) float32
    mask: torch.Tensor     # (b,) bool

    @staticmethod
    def from_numpy(src, dst, t, feat, mask, device) -> "EventBatch":
        """Move numpy columns to `device` (node ids as int64 indices)."""
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
        return EventBatch(src=as_t(src, torch.int64),
                          dst=as_t(dst, torch.int64),
                          t=as_t(t, torch.float32),
                          feat=as_t(feat, torch.float32),
                          mask=as_t(mask, torch.bool))


@dataclasses.dataclass
class EventStream:
    """Full chronological stream (host-side, numpy)."""
    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    feat: np.ndarray
    num_nodes: int

    def __len__(self) -> int:
        return len(self.src)

    @property
    def feat_dim(self) -> int:
        return self.feat.shape[1]

    def slice(self, lo: int, hi: int) -> "EventStream":
        return EventStream(self.src[lo:hi], self.dst[lo:hi], self.t[lo:hi],
                           self.feat[lo:hi], self.num_nodes)

    def chronological_split(self, train: float = 0.7, val: float = 0.15):
        """Paper App. A: split [0, T] chronologically into train/val/test."""
        n = len(self)
        i1, i2 = int(n * train), int(n * (train + val))
        return self.slice(0, i1), self.slice(i1, i2), self.slice(i2, n)

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)

    def iter_temporal_batches(self, batch_size: int, device=None):
        """Carve fixed-size temporal batches, lazily, onto `device` (cuda
        unless "cpu" is given). The last one is zero-padded and masked, so
        every batch has the same shapes; the values are the JAX carve's
        (node ids widened to int64 indices)."""
        dev = resolve_device(device)
        for lo in range(0, len(self), batch_size):
            hi = min(lo + batch_size, len(self))
            pad = batch_size - (hi - lo)
            mk = lambda a: (np.concatenate(
                [a[lo:hi], np.zeros((pad,) + a.shape[1:], a.dtype)])
                if pad else a[lo:hi])
            yield EventBatch.from_numpy(
                mk(self.src), mk(self.dst), mk(self.t), mk(self.feat),
                np.arange(batch_size) < (hi - lo), dev)

    def temporal_batches(self, batch_size: int, device=None):
        """K = ceil(|E| / b) temporal batches (the last one padded)."""
        return list(self.iter_temporal_batches(batch_size, device))

    def prefetch_batches(self, batch_size: int, device=None,
                         depth: int = 2) -> "PrefetchIterator":
        """`iter_temporal_batches` carved on a background thread that keeps
        up to `depth` batches ready ahead of the consumer (the pipelined
        schedule's host prefetch)."""
        return prefetch(self.iter_temporal_batches(
            batch_size, resolve_device(device)), depth)

    def train_serve_split(self, serve_frac: float = 0.3):
        """Offline-training prefix and online-serving tail (the last
        `serve_frac` of the events)."""
        if not 0.0 < serve_frac < 1.0:
            raise ValueError(f"serve_frac must be in (0, 1), got {serve_frac}")
        cut = int(len(self) * (1.0 - serve_frac))
        return self.slice(0, cut), self.slice(cut, len(self))

    def reorder(self, perm: np.ndarray) -> "EventStream":
        """Apply a delivery permutation; timestamps keep their values."""
        return EventStream(self.src[perm], self.dst[perm], self.t[perm],
                           self.feat[perm], self.num_nodes)


def _prefetch_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Blocking put that gives up once the consumer has closed (or
    dropped) the iterator, so an abandoned producer does not spin."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _produce(it, q: queue.Queue, stop: threading.Event, done) -> None:
    try:
        for item in it:
            if not _prefetch_put(q, stop, item):
                return
        _prefetch_put(q, stop, done)
    except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
        _prefetch_put(q, stop, e)


class PrefetchIterator:
    """An iterator drained by a daemon producer thread into a queue of at
    most `depth` items, so batch preparation overlaps the consumer's
    device work. An exception of the source is re-raised at the
    consumer's next `__next__`; `close()`, exhaustion, or garbage
    collection stops the producer.

    The JAX version times the consumer's waits as an `obs` trace span
    ("prefetch_wait"); the port has no `obs` layer yet (ROADMAP Queue 1
    item 14), so nothing is timed here."""

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # the thread closes over the queue and the event, not over self, so
        # an abandoned iterator can be collected and its finalizer stops it
        self._thread = threading.Thread(
            target=_produce, args=(iter(source), self._queue, self._stop,
                                   self._DONE), daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(self, self._stop.set)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()


def prefetch(source: Iterable, depth: int = 2) -> Iterator:
    """Background-thread prefetch of `depth` items from `source`."""
    return PrefetchIterator(source, depth)


def poisson_arrival_clock(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Wall-clock arrival times of `n` events from a Poisson process of
    `rate` events/sec (the replay's ingestion clock, not model time)."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0 events/sec, got {rate}")
    rng = np.random.default_rng(seed)
    return rng.exponential(1.0 / rate, n).cumsum()


def late_arrival_order(n: int, frac: float, max_late: int,
                       seed: int = 0) -> np.ndarray:
    """Delivery permutation delaying a `frac` subset of events by at most
    `max_late` positions. Returns indices in delivery order."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"late fraction must be in [0, 1], got {frac}")
    if max_late < 0:
        raise ValueError(f"max_late must be >= 0, got {max_late}")
    keys = np.arange(n, dtype=np.float64)
    if frac > 0.0 and max_late > 0:
        rng = np.random.default_rng(seed)
        late = rng.random(n) < frac
        # +0.5 breaks ties toward "after the on-time event at that slot"
        keys[late] += rng.integers(1, max_late + 1, int(late.sum())) + 0.5
    return np.argsort(keys, kind="stable")


def load_jodie_csv(path: str, num_nodes: int | None = None) -> EventStream:
    """The public JODIE dataset format,
    user_id,item_id,timestamp,state_label,feature0,feature1,...
    with items offset into a bipartite id space after the users, in a
    stable chronological order; no feature columns give one zero feature.

    One np.loadtxt pass over the file. Only when it trips on a malformed
    row does a tolerant re-read drop the rows with fewer than four fields
    (blank or truncated lines); both passes share the parser, so the
    arrays are the JAX loader's byte for byte."""
    try:
        data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                          ndmin=2)
    except ValueError:
        import io
        with open(path) as f:
            f.readline()                               # header
            rows = [ln for ln in f if ln.count(",") >= 3]
        data = np.loadtxt(io.StringIO("".join(rows)), delimiter=",",
                          dtype=np.float64, ndmin=2)
    src = data[:, 0].astype(np.int32)
    dst = data[:, 1].astype(np.int32) + (src.max() + 1)
    feat = (data[:, 4:].astype(np.float32) if data.shape[1] > 4
            else np.zeros((len(data), 1), np.float32))
    n = num_nodes or int(max(src.max(), dst.max()) + 1)
    order = np.argsort(data[:, 2], kind="stable")
    return EventStream(src[order], dst[order],
                       data[:, 2].astype(np.float32)[order], feat[order], n)
