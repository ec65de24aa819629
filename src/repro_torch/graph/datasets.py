"""Synthetic dynamic-graph generators (numpy copies of
`repro/graph/datasets.py`; byte-identical output for the same seed).

`generate` builds the in-RAM JODIE-style streams of `SPECS`; `stream_chunk`
is the stateless hashed power-law generator behind `STREAM_SPECS`, whose
events [lo, hi) depend on nothing but (spec, seed, lo, hi)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.events import EventStream


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    n_users: int
    n_items: int
    n_events: int
    feat_dim: int
    n_communities: int = 8
    drift_rate: float = 0.002      # chance a user switches community per event
    zipf_a: float = 1.3            # user-activity skew (pending-event pressure)
    noise: float = 0.15            # chance of a uniform-random item


SPECS = {
    "wiki-small": SyntheticSpec("wiki-small", 800, 200, 20_000, 16),
    "reddit-small": SyntheticSpec("reddit-small", 1000, 100, 30_000, 16),
    "mooc-small": SyntheticSpec("mooc-small", 600, 70, 15_000, 0),
    "lastfm-small": SyntheticSpec("lastfm-small", 200, 1000, 25_000, 0),
    "gdelt-small": SyntheticSpec("gdelt-small", 1200, 400, 40_000, 24,
                                 n_communities=16, zipf_a=1.2),
}


def generate(spec: SyntheticSpec, seed: int = 0) -> EventStream:
    rng = np.random.default_rng(seed)
    n = spec.n_users + spec.n_items
    user_comm = rng.integers(0, spec.n_communities, spec.n_users)
    item_weights = rng.dirichlet(np.full(spec.n_items, 0.05), spec.n_communities)
    act = rng.zipf(spec.zipf_a, spec.n_users).astype(np.float64)
    act = act / act.sum()

    users = rng.choice(spec.n_users, spec.n_events, p=act)
    ts = np.sort(rng.exponential(1.0, spec.n_events).cumsum()).astype(np.float32)
    items = np.empty(spec.n_events, np.int64)
    feat_dim = max(spec.feat_dim, 1)
    feat = rng.normal(0, 0.1, (spec.n_events, feat_dim)).astype(np.float32)
    for i, u in enumerate(users):
        if rng.random() < spec.drift_rate:
            user_comm[u] = rng.integers(0, spec.n_communities)
        if rng.random() < spec.noise:
            items[i] = rng.integers(0, spec.n_items)
        else:
            items[i] = rng.choice(spec.n_items, p=item_weights[user_comm[u]])
        if spec.feat_dim:
            feat[i, user_comm[u] % spec.feat_dim] += 1.0  # weak community signal
    if not spec.feat_dim:
        feat = np.zeros((spec.n_events, 1), np.float32)
    return EventStream(users.astype(np.int32),
                       (spec.n_users + items).astype(np.int32),
                       ts, feat, n)


def get_dataset(name: str, seed: int = 0) -> EventStream:
    return generate(SPECS[name], seed)


_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_MUL2 = np.uint64(0x94D049BB133111EB)
_N_STREAMS = 64        # independent hash streams per event (feat cap + 4)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer (uint64, wrapping mod 2^64)."""
    with np.errstate(over="ignore"):
        z = (x + _SM_GAMMA).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(30))) * _SM_MUL1).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(27))) * _SM_MUL2).astype(np.uint64)
        return z ^ (z >> np.uint64(31))


def _u01(seed: int, idx: np.ndarray, stream: int) -> np.ndarray:
    """Deterministic uniforms in [0, 1): one 53-bit draw per (event, stream)."""
    key = _splitmix64(np.uint64(seed) * np.uint64(_N_STREAMS + 1)
                      + np.uint64(stream))
    h = _splitmix64(idx.astype(np.uint64) * np.uint64(_N_STREAMS)
                    + np.uint64(stream) + key)
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _power_rank(u: np.ndarray, n: int, exponent: float) -> np.ndarray:
    """Inverse-CDF bounded power-law rank in [0, n)."""
    if exponent <= 1.0:
        raise ValueError(f"power-law exponent must be > 1, got {exponent}")
    one_minus_a = 1.0 - exponent
    hi = float(n + 1) ** one_minus_a
    x = (1.0 + u * (hi - 1.0)) ** (1.0 / one_minus_a)
    return np.minimum(x.astype(np.int64) - 1, n - 1)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Streaming bipartite power-law event stream (user -> item)."""
    name: str
    n_users: int
    n_items: int
    n_events: int
    feat_dim: int
    exponent: float = 1.6
    noise: float = 0.1
    dt: float = 1.0

    @property
    def num_nodes(self) -> int:
        return self.n_users + self.n_items


STREAM_SPECS = {
    "stream-tiny": StreamSpec("stream-tiny", 2_000, 500, 50_000, 8),
    "stream-small": StreamSpec("stream-small", 100_000, 20_000, 1_000_000, 16),
    "stream-10m": StreamSpec("stream-10m", 1_000_000, 200_000, 10_000_000, 32),
    "stream-100m": StreamSpec("stream-100m", 8_000_000, 1_000_000,
                              100_000_000, 32),
}


def stream_chunk(spec: StreamSpec, seed: int, lo: int, hi: int):
    """Events [lo, hi) of the deterministic stream: (src, dst, t, feat)."""
    if spec.feat_dim + 4 > _N_STREAMS:
        raise ValueError(f"feat_dim {spec.feat_dim} exceeds the "
                         f"{_N_STREAMS - 4} hash streams reserved for it")
    idx = np.arange(lo, hi, dtype=np.uint64)
    users = _power_rank(_u01(seed, idx, 0), spec.n_users, spec.exponent)
    base = _power_rank(_u01(seed, idx, 1), spec.n_items, spec.exponent)
    offset = (_splitmix64(users.astype(np.uint64)
                          + np.uint64(seed)) % np.uint64(spec.n_items)
              ).astype(np.int64)
    items = (base + offset) % spec.n_items
    uniform = np.minimum((_u01(seed, idx, 2) * spec.n_items).astype(np.int64),
                         spec.n_items - 1)
    noisy = _u01(seed, idx, 3) < spec.noise
    items = np.where(noisy, uniform, items)
    t = ((idx.astype(np.float64) + _u01(seed, idx, 4)) * spec.dt
         ).astype(np.float32)
    feat_dim = max(spec.feat_dim, 1)
    feat = np.empty((hi - lo, feat_dim), np.float32)
    for k in range(feat_dim):
        feat[:, k] = (_u01(seed, idx, 5 + k) * 0.2 - 0.1).astype(np.float32)
    if spec.feat_dim:
        cols = (users % feat_dim).astype(np.int64)
        feat[np.arange(hi - lo), cols] += 1.0    # weak preference signal
    return (users.astype(np.int32),
            (spec.n_users + items).astype(np.int32), t, feat)


def stream_events(spec: StreamSpec, seed: int, n_events: int) -> EventStream:
    """The first `n_events` of `spec` as an in-RAM EventStream."""
    src, dst, t, feat = stream_chunk(spec, seed, 0, n_events)
    return EventStream(src, dst, t, feat, spec.num_nodes)
