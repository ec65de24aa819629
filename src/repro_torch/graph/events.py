"""Event-based dynamic graph representation (counterpart of
`repro/graph/events.py`): `EventBatch` holds one padded temporal batch as
tensors, `EventStream` the host-side chronological stream as numpy
arrays, plus the serving replay's arrival-clock helpers (numpy copies)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
