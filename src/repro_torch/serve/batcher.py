"""Micro-batcher (counterpart of `repro/serve/batcher.py`): pad each
request up to the smallest bucket that fits, and split requests larger
than the biggest bucket, so the engine sees a bounded set of shapes.
Padding rows are masked off; the fold is pad-invariant."""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.graph.events import EventBatch

DEFAULT_BUCKETS = (16, 64, 256, 1024)


class MicroBatcher:
    """Pad-to-bucket request coalescing for the serve engine."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 d_edge: int = 1):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.d_edge = int(d_edge)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits `n` (requires n <= max_bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"request of {n} exceeds the largest bucket "
                         f"{self.max_bucket}; split it first (chunk_spans)")

    def chunk_spans(self, n: int) -> Iterator[tuple[int, int]]:
        """(lo, hi) spans covering 0..n, each span <= max_bucket."""
        for lo in range(0, n, self.max_bucket):
            yield lo, min(lo + self.max_bucket, n)

    def pad_events(self, src, dst, t, feat=None, *,
                   device) -> Iterator[EventBatch]:
        """Bucket-padded EventBatches on `device` covering the request in
        order; `feat` None means zero edge features."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        t = np.asarray(t, np.float32)
        n = len(src)
        if feat is None:
            feat = np.zeros((n, self.d_edge), np.float32)
        feat = np.asarray(feat, np.float32)
        for lo, hi in self.chunk_spans(n):
            b = self.bucket_for(hi - lo)
            pad = b - (hi - lo)
            mk = lambda a: (np.concatenate(
                [a[lo:hi], np.zeros((pad,) + a.shape[1:], a.dtype)])
                if pad else a[lo:hi])
            yield EventBatch.from_numpy(mk(src), mk(dst), mk(t), mk(feat),
                                        np.arange(b) < (hi - lo), device)

    def pad_query(self, src, dst, t, *, device):
        """One bucket-padded query chunk on `device`: (src, dst, t,
        n_valid); requires len <= max_bucket."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        t = np.asarray(t, np.float32)
        n = len(src)
        pad = self.bucket_for(n) - n
        if pad:
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.zeros(pad, np.int32)])
            t = np.concatenate([t, np.zeros(pad, np.float32)])
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        return (as_t(src, torch.int64), as_t(dst, torch.int64),
                as_t(t, torch.float32), n)
