"""The frozen traffic generator: the port's stream bit for bit, the same
events for the same seed, any window without the events before it."""
from __future__ import annotations

import numpy as np
import torch

from chipbench.traffic import stream


def test_same_seed_same_events_and_windows_stand_alone():
    seed = 2**31 + 12345
    a = stream.events(1000, 200, seed, 0, 5000)
    b = stream.events(1000, 200, seed, 0, 5000)
    w = stream.events(1000, 200, seed, 3000, 5000)
    for x, y, z in zip(a, b, w):
        assert np.array_equal(x, y)
        assert np.array_equal(x[3000:], z)
    c = stream.events(1000, 200, seed + 1, 0, 5000)
    assert not np.array_equal(a[0], c[0])


def test_ids_times_ranges():
    src, dst, t = stream.events(1000, 200, 7, 0, 20000)
    assert src.min() >= 0 and src.max() < 1000
    assert dst.min() >= 1000 and dst.max() < 1200
    assert np.all(np.diff(t) > 0)


def test_matches_the_ports_stream_chunk():
    from repro_torch.graph.datasets import StreamSpec, stream_chunk
    spec = StreamSpec("t", 5000, 700, 10000, 4)
    for seed in (0, 123456789012):
        src, dst, t, _ = stream_chunk(spec, seed, 100, 4100)
        s2, d2, t2 = stream.events(5000, 700, seed, 100, 4100)
        assert np.array_equal(src, s2) and np.array_equal(dst, d2)
        assert np.array_equal(t, t2)


def test_features_by_seed():
    src = torch.arange(50)
    f1 = stream.features(src, 8, torch.Generator().manual_seed(5))
    f2 = stream.features(src, 8, torch.Generator().manual_seed(5))
    assert torch.equal(f1, f2) and f1.shape == (50, 8)
    assert torch.all(f1[torch.arange(50), src % 8] > 0.8)
