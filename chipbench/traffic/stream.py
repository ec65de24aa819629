"""The traffic generator: a frozen copy of the port's stateless hashed
power-law stream (`repro_torch/graph/datasets.py::stream_chunk`), ids and
times only, plus the wide edge features drawn from the seed on the device.

Events [lo, hi) depend on nothing but (n_users, n_items, exponent, noise,
seed, lo, hi), so any window of a stream is made without the events
before it, and the same seed gives the same events. Times are the event's
index plus a uniform fraction, strictly increasing. Users are ids
[0, n_users), items [n_users, n_users + n_items)."""
from __future__ import annotations

import numpy as np
import torch

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_MUL2 = np.uint64(0x94D049BB133111EB)
_N_STREAMS = 64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _SM_GAMMA).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(30))) * _SM_MUL1).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(27))) * _SM_MUL2).astype(np.uint64)
        return z ^ (z >> np.uint64(31))


def _u01(seed: int, idx: np.ndarray, stream: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        key = _splitmix64(np.uint64(seed % (1 << 64))
                          * np.uint64(_N_STREAMS + 1) + np.uint64(stream))
        h = _splitmix64(idx.astype(np.uint64) * np.uint64(_N_STREAMS)
                        + np.uint64(stream) + key)
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _power_rank(u: np.ndarray, n: int, exponent: float) -> np.ndarray:
    one_minus_a = 1.0 - exponent
    hi = float(n + 1) ** one_minus_a
    x = (1.0 + u * (hi - 1.0)) ** (1.0 / one_minus_a)
    return np.minimum(x.astype(np.int64) - 1, n - 1)


def events(n_users: int, n_items: int, seed: int, lo: int, hi: int,
           exponent: float = 1.6, noise: float = 0.1):
    """Events [lo, hi): (src int64, dst int64, t float32) numpy arrays."""
    if exponent <= 1.0:
        raise ValueError(f"power-law exponent must be > 1, got {exponent}")
    idx = np.arange(lo, hi, dtype=np.uint64)
    users = _power_rank(_u01(seed, idx, 0), n_users, exponent)
    base = _power_rank(_u01(seed, idx, 1), n_items, exponent)
    with np.errstate(over="ignore"):
        offset = (_splitmix64(users.astype(np.uint64)
                              + np.uint64(seed % (1 << 64)))
                  % np.uint64(n_items)).astype(np.int64)
    items = (base + offset) % n_items
    uniform = np.minimum((_u01(seed, idx, 2) * n_items).astype(np.int64),
                         n_items - 1)
    items = np.where(_u01(seed, idx, 3) < noise, uniform, items)
    t = (idx.astype(np.float64) + _u01(seed, idx, 4)).astype(np.float32)
    return users.astype(np.int64), (n_users + items).astype(np.int64), t


def features(src: torch.Tensor, d_edge: int, generator: torch.Generator):
    """(n, d_edge) float32 edge features on src's device, in one draw:
    uniform in [-0.1, 0.1) plus 1 at column src % d_edge (the stream's
    weak preference signal)."""
    n = src.shape[0]
    feat = torch.rand((n, d_edge), generator=generator,
                      device=src.device) * 0.2 - 0.1
    feat[torch.arange(n, device=src.device), src % d_edge] += 1.0
    return feat
