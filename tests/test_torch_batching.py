"""The port's batching and PRES-tracker functions against the JAX package
on the CPU: lexsort tie order, ring-buffer slot collisions, drop-slot
scatters, frontier compaction at depths 1 and 2, and the tracker update.
Integer outputs must match exactly; float sums to 1e-6 absolute (the same
additions in another order)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batching as jb
from repro.core import pres as jpres
from repro.graph.events import EventBatch as JBatch
from repro.models import mdgnn as jmdgnn

from repro_torch import bridge
from repro_torch.core import batching as tb
from repro_torch.core import pres as tpres
from repro_torch.graph.events import EventBatch
from repro_torch.models import mdgnn as tmdgnn


def _batch_pair(src, dst, t, mask):
    n = len(src)
    feat = np.zeros((n, 1), np.float32)
    jbatch = JBatch(src=jnp.asarray(src, jnp.int32),
                    dst=jnp.asarray(dst, jnp.int32),
                    t=jnp.asarray(t, jnp.float32), feat=jnp.asarray(feat),
                    mask=jnp.asarray(mask))
    return jbatch, EventBatch.from_numpy(src, dst, t, feat, mask, "cpu")


def _neighbors_np(nb):
    return {k: np.asarray(v) for k, v in nb.items()}


def _port_neighbors(np_nb):
    st = bridge.state_from_numpy(
        {"memory": {"mem": np.zeros((1, 1)), "last_update": np.zeros(1)},
         "neighbors": np_nb,
         "pres": {"n": np.zeros((1, 2)), "xi": np.zeros((1, 2, 1)),
                  "psi": np.zeros((1, 2, 1))}}, "cpu")
    return st["neighbors"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occurrence_order_ties_match_jax(seed):
    """Equal timestamps and masked rows (keyed -inf / INT32_MAX) sort in
    exactly the jnp.lexsort order."""
    rng = np.random.default_rng(seed)
    m = 64
    nodes = rng.integers(0, 6, m).astype(np.int32)
    times = rng.integers(0, 3, m).astype(np.float32)     # many ties
    mask = rng.random(m) < 0.8
    want = np.asarray(jmdgnn.occurrence_order(nodes, times, mask))
    got = tmdgnn.occurrence_order(torch.as_tensor(nodes).long(),
                                  torch.as_tensor(times),
                                  torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmdgnn._last_occurrence_flags(torch.as_tensor(nodes).long(),
                                      torch.as_tensor(times),
                                      torch.as_tensor(mask)).numpy(),
        np.asarray(jmdgnn._last_occurrence_flags(nodes, times, mask)))


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 100)
    b = rng.integers(0, 4, 100)
    c = rng.integers(0, 4, 100)
    got = tb.lexsort((torch.as_tensor(a), torch.as_tensor(b),
                      torch.as_tensor(c)))
    np.testing.assert_array_equal(got.numpy(), np.lexsort((a, b, c)))


@pytest.mark.parametrize("case", ["collision_k2", "mixed"])
def test_ring_buffer_append_matches_jax(case):
    """K=2 with one node in 5 events (more occurrences than slots, so the
    JAX scatter writes duplicate slots) and a masked mixed batch."""
    n, k = 6, 2
    if case == "collision_k2":
        src = np.array([1, 1, 1, 1, 1], np.int32)
        dst = np.array([2, 3, 4, 5, 2], np.int32)
        t = np.arange(5, dtype=np.float32)
        mask = np.ones(5, bool)
    else:
        rng = np.random.default_rng(4)
        src = rng.integers(0, n, 12).astype(np.int32)
        dst = rng.integers(0, n, 12).astype(np.int32)
        t = np.sort(rng.random(12) * 10).astype(np.float32)
        mask = rng.random(12) < 0.75
    jbatch, tbatch = _batch_pair(src, dst, t, mask)
    jnb = jb.init_neighbors(n, k)
    jnb = jb.update_neighbors(jnb, jbatch)       # fill first, then wrap
    jnb2 = jb.update_neighbors(jnb, jbatch)
    tnb = _port_neighbors(_neighbors_np(jb.init_neighbors(n, k)))
    tb.update_neighbors(tnb, tbatch)
    tb.update_neighbors(tnb, tbatch)
    for key in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(tnb[key][:-1].numpy(),
                                      np.asarray(jnb2[key]), err_msg=key)


def test_masked_writes_go_to_dump_row():
    """Drop-slot scatters: a fully masked batch leaves rows [:N] as they
    were, in the rings and in the memory-table pass."""
    n, k = 5, 3
    _, tbatch = _batch_pair(np.array([1, 2], np.int32),
                            np.array([3, 4], np.int32),
                            np.array([1.0, 2.0], np.float32),
                            np.zeros(2, bool))
    tnb = tb.init_neighbors(n, k, "cpu")
    before = {kk: v.clone() for kk, v in tnb.items()}
    tb.update_neighbors(tnb, tbatch)
    for kk in tnb:
        assert torch.equal(tnb[kk][:-1], before[kk][:-1])


@pytest.mark.parametrize("budget_cut", [False, True])
def test_compact_unique_matches_jax(budget_cut):
    rng = np.random.default_rng(5)
    nodes = rng.integers(0, 7, 40).astype(np.int32)
    t = rng.integers(0, 3, 40).astype(np.float32)
    budget = 8 if budget_cut else 40
    want = jb.compact_unique(jnp.asarray(nodes), jnp.asarray(t), budget)
    got = tb.compact_unique(torch.as_tensor(nodes).long(),
                            torch.as_tensor(t), budget)
    for key in ("nodes", "t", "inverse", "n_unique"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("n_hops", [1, 2])
def test_expand_frontiers_unique_matches_jax(tiny_stream, n_hops):
    n, k = tiny_stream.num_nodes, 4
    s, d, t = tiny_stream.src[:150], tiny_stream.dst[:150], tiny_stream.t[:150]
    jbatch, tbatch = _batch_pair(s, d, t, np.ones(150, bool))
    jnb = jb.update_neighbors(jb.init_neighbors(n, k), jbatch)
    tnb = tb.init_neighbors(n, k, "cpu")
    tb.update_neighbors(tnb, tbatch)
    seeds = np.concatenate([s[:10], d[:10]]).astype(np.int32)
    tq = np.concatenate([t[:10], t[:10]]).astype(np.float32) + 1.0
    want = jb.expand_frontiers_unique(jnb, jnp.asarray(seeds),
                                      jnp.asarray(tq), n_hops, n)
    got = tb.expand_frontiers_unique(tnb, torch.as_tensor(seeds).long(),
                                     torch.as_tensor(tq), n_hops, n)
    assert len(got) == len(want) == n_hops + 1
    for gh, wh in zip(got[1:], want[1:]):
        for key in ("nodes", "t", "inverse", "n_unique", "valid", "t_edge"):
            np.testing.assert_array_equal(np.asarray(gh[key]),
                                          np.asarray(wh[key]), err_msg=key)


def test_update_trackers_matches_jax():
    rng = np.random.default_rng(6)
    n, dm, m = 9, 5, 30
    nodes = rng.integers(0, n, m).astype(np.int32)
    delta = rng.normal(size=(m, dm)).astype(np.float32)
    mask = rng.random(m) < 0.7
    etype = np.zeros(m, np.int32)
    st = jpres.PresState.init(n, dm)
    st = jpres.update_trackers(st, nodes, delta, etype, mask)
    want = jpres.update_trackers(st, nodes, delta, etype, mask)
    got = tpres.PresState.init(n, dm, "cpu")
    for _ in range(2):
        tpres.update_trackers(got, torch.as_tensor(nodes).long(),
                              torch.as_tensor(delta),
                              torch.zeros(m, dtype=torch.int64),
                              torch.as_tensor(mask))
    rows = got.rows()
    np.testing.assert_array_equal(rows.n.numpy(), np.asarray(want.n))
    np.testing.assert_allclose(rows.xi.numpy(), np.asarray(want.xi),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(rows.psi.numpy(), np.asarray(want.psi),
                               atol=1e-6, rtol=0)
    ids = torch.as_tensor(nodes).long()
    np.testing.assert_allclose(
        tpres.mixture_mean(got, ids).numpy(),
        np.asarray(jpres.mixture_mean(want, nodes)), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# pending sets, the last-message reduction and the dedup probe
# ---------------------------------------------------------------------------


def _pending_inputs(seed, b=48, n=12):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, b).astype(np.int32)
    dst = rng.integers(0, n, b).astype(np.int32)
    t = rng.integers(0, 10, b).astype(np.float32)     # many equal times
    mask = rng.random(b) < 0.8
    return src, dst, t, mask


@pytest.mark.parametrize("masked", [False, True])
def test_pending_counts_matches_jax(masked):
    src, dst, t, mask = _pending_inputs(7)
    m = mask if masked else None
    want = jb.pending_counts(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(t),
                             None if m is None else jnp.asarray(m))
    got = tb.pending_counts(torch.as_tensor(src).long(),
                            torch.as_tensor(dst).long(), torch.as_tensor(t),
                            None if m is None else torch.as_tensor(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [8, 9])
def test_pending_fraction_matches_jax(seed):
    jbatch, tbatch = _batch_pair(*_pending_inputs(seed))
    assert tb.pending_fraction(tbatch) == jb.pending_fraction(jbatch)


@pytest.mark.parametrize("seed", [10, 11])
def test_last_per_node_matches_jax(seed):
    """Ties of time within a node, masked latest rows and nodes with only
    masked rows: the taken row, its time and the touched flags exact."""
    rng = np.random.default_rng(seed)
    m, n, d = 60, 15, 3
    nodes = rng.integers(0, n, m).astype(np.int32)
    times = rng.integers(0, 6, m).astype(np.float32)
    values = rng.normal(size=(m, d)).astype(np.float32)
    mask = rng.random(m) < 0.7
    want = jb.last_per_node(jnp.asarray(nodes), jnp.asarray(times),
                            jnp.asarray(values), jnp.asarray(mask), n)
    got = tb.last_per_node(torch.as_tensor(nodes).long(),
                           torch.as_tensor(times), torch.as_tensor(values),
                           torch.as_tensor(mask), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_hops", [1, 2])
def test_frontier_dedup_stats_matches_jax(tiny_stream, n_hops):
    n, k = tiny_stream.num_nodes, 4
    s, d, t = tiny_stream.src[:200], tiny_stream.dst[:200], tiny_stream.t[:200]
    jbatch, tbatch = _batch_pair(s, d, t, np.ones(200, bool))
    jnb = jb.update_neighbors(jb.init_neighbors(n, k), jbatch)
    tnb = tb.init_neighbors(n, k, "cpu")
    tb.update_neighbors(tnb, tbatch)
    seeds = np.concatenate([s[:16], d[:16]]).astype(np.int32)
    tq = np.concatenate([t[:16], t[:16]]).astype(np.float32) + 1.0
    want = jb.frontier_dedup_stats(jnb, jnp.asarray(seeds), jnp.asarray(tq),
                                   n_hops, n)
    got = tb.frontier_dedup_stats(tnb, torch.as_tensor(seeds).long(),
                                  torch.as_tensor(tq), n_hops, n)
    assert got == want
