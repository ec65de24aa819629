"""The serve engine's per-bucket preparation and the offline-parity gate
on the CPU: `check_offline_parity` (engine against `loop.make_eval_step`
in lock step, the JAX gate's 1e-5), `trace_counts` keyed as JAX keys its
traces (each key once, bounded by the bucket table, none added by live
traffic after `warmup()`), the replay's `post_warmup_traces`, the static
buffers against the bodies called on the padded request directly (bit
for bit), which bodies a config captures on the card, the launch census
that replays add to the counters, and the state that cannot be re-bound
under a captured graph.

The CPU never captures: the bodies run eagerly on the static buffers,
so the same engine code runs, the graphs aside (`chip_smoke.py` holds the
captured engine to the eager one on the card)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.graph import datasets as tdatasets
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ops
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.serve import (MicroBatcher, ServeEngine, captured_bodies,
                               check_offline_parity, replay)

BUCKETS = (16, 64)


@pytest.fixture(scope="module")
def stream():
    return tdatasets.generate(tdatasets.SyntheticSpec("tiny", 50, 30, 600, 8),
                              seed=0)


DST = (50, 80)


def _cfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, use_pres=True, use_kernels=True)
    base.update(kw)
    return tmdgnn.MDGNNConfig(**base)


def _engine(cfg, buckets=BUCKETS, seed=0, **kw):
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    return ServeEngine(cfg, params, tmdgnn.init_state(cfg, "cpu"),
                       item_range=DST, device="cpu",
                       batcher=MicroBatcher(buckets=buckets,
                                            d_edge=cfg.d_edge), **kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_kernels=False), dict(variant="apan"),
    dict(variant="jodie")], ids=["tgn-pres", "tgn-pres-plain", "apan",
                                 "jodie"])
def test_offline_parity(stream, kw):
    """The engine reproduces the evaluator's scores within 1e-5 over the
    whole stream, and prepared each key once, within 2 x buckets."""
    cfg = _cfg(stream, **kw)
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(1),
                                "cpu")
    state = tmdgnn.init_state(cfg, "cpu")
    max_diff, n_scored, eng = check_offline_parity(
        cfg, params, state, stream, DST, device="cpu",
        batcher=MicroBatcher(buckets=BUCKETS, d_edge=cfg.d_edge))
    assert n_scored > 1000
    assert max_diff < 1e-5, f"serve/evaluate drift: {max_diff}"
    assert eng.trace_counts and all(c == 1 for c in
                                    eng.trace_counts.values())
    assert len(eng.trace_counts) <= 2 * len(BUCKETS)
    assert torch.count_nonzero(state["memory"].mem) == 0   # left as it was


def test_trace_counts_bounded_by_bucket_table(stream):
    """Requests of any size prepare each (kind, bucket) once, and only at
    bucket sizes."""
    eng = _engine(_cfg(stream))
    rng = np.random.default_rng(0)
    for n in (1, 3, 16, 17, 40, 64, 64, 100, 5, 130):
        lo = int(rng.integers(0, len(stream) - 150))
        s, d, t = (stream.src[lo:lo + n], stream.dst[lo:lo + n],
                   stream.t[lo:lo + n])
        eng.ingest(s, d, t, stream.feat[lo:lo + n])
        eng.query(s, d, t)
    for (kind, size, *_), count in eng.trace_counts.items():
        assert size in BUCKETS, f"{kind} prepared off-bucket size {size}"
        assert count == 1, f"{kind}@{size} prepared {count} times"
    assert len(eng.trace_counts) <= 2 * len(BUCKETS)


def test_warmup_prepares_every_key_and_traffic_adds_none(stream):
    eng = _engine(_cfg(stream))
    eng.warmup(topk_k=3)
    warm = dict(eng.trace_counts)
    assert set(warm) == {(kind, b) for kind in ("ingest", "query")
                         for b in BUCKETS} | {("topk", b, 3)
                                              for b in BUCKETS}
    eng.ingest(stream.src[:40], stream.dst[:40], stream.t[:40],
               stream.feat[:40])
    eng.query(stream.src[:10], stream.dst[:10], stream.t[:10])
    eng.recommend_topk(stream.src[:4], stream.t[:4], 3)
    assert dict(eng.trace_counts) == warm, "live traffic prepared a key"
    rep = replay(eng, stream, DST, rate=20000.0, tick=0.004, query_batch=8,
                 max_events=300, seed=0, warmup=False)
    assert rep.post_warmup_traces == {}


def test_replay_reports_keys_prepared_during_it(stream):
    """Without warm-up every key the replay meets is prepared during it,
    once: post_warmup_traces names them, as JAX's does its traces."""
    eng = _engine(_cfg(stream))
    rep = replay(eng, stream, DST, rate=20000.0, tick=0.004, query_batch=8,
                 max_events=300, seed=0, warmup=False)
    assert rep.post_warmup_traces == dict(eng.trace_counts)
    assert set(rep.post_warmup_traces) <= {
        (kind, b) for kind in ("ingest", "query") for b in BUCKETS}
    assert all(c == 1 for c in rep.post_warmup_traces.values())


@pytest.mark.parametrize("n", [5, 16, 40])
def test_static_buffers_match_direct_bodies(stream, n):
    """Query and top-k through the static buffers give, bit for bit, the
    bodies called on the padded request (the engine before buffers)."""
    eng = _engine(_cfg(stream))
    eng.ingest(stream.src[:200], stream.dst[:200], stream.t[:200],
               stream.feat[:200])
    s, d, t = (stream.src[200:200 + n], stream.dst[200:200 + n],
               stream.t[200:200 + n])
    ps, pd, pt, valid = eng.batcher.pad_query(s, d, t, device="cpu")
    want = eng._query_body(ps, pd, pt)[:valid].numpy()
    assert np.array_equal(eng.query(s, d, t), want)
    vals, ids = eng._topk_body(ps, pt, 5)
    got_v, got_i = eng.recommend_topk(s, t, 5)
    assert np.array_equal(got_v, vals[:valid].numpy())
    assert np.array_equal(got_i, ids[:valid].to(torch.int32).numpy())


def test_static_buffers_fold_as_direct_bodies(stream):
    """Folds through the static buffers leave the state that the ingest
    body leaves on the padded batches directly."""
    cfg = _cfg(stream)
    a, b = _engine(cfg), _engine(cfg)
    for lo, n in ((0, 40), (40, 3), (43, 64), (107, 100)):
        sl = slice(lo, lo + n)
        a.ingest(stream.src[sl], stream.dst[sl], stream.t[sl],
                 stream.feat[sl])
        for eb in b.batcher.pad_events(stream.src[sl], stream.dst[sl],
                                       stream.t[sl], stream.feat[sl],
                                       device="cpu"):
            b._ingest_body(eb)
    sa, sb = tmdgnn.clone_state(a.state), tmdgnn.clone_state(b.state)
    assert torch.equal(sa["memory"].mem, sb["memory"].mem)
    for k in ("nbr", "t", "ptr"):
        assert torch.equal(sa["neighbors"][k], sb["neighbors"][k])
    assert torch.equal(sa["pres"].xi, sb["pres"].xi)


def test_captured_bodies_follow_the_config(stream):
    """Ingest is captured where the fold is the memory_update_table
    kernel (PRES, GRU, kernels that launch); query and top-k always."""
    base = _cfg(stream)
    fused = [base, dataclasses.replace(base, dedup_embed=False),
             dataclasses.replace(base, variant="apan"),
             dataclasses.replace(base, variant="jodie"),
             dataclasses.replace(base, kernels_mode="compiled")]
    eager = [dataclasses.replace(base, memory_cell="rnn"),
             dataclasses.replace(base, use_pres=False),
             dataclasses.replace(base, use_kernels=False),
             dataclasses.replace(base, kernels_mode="oracle")]
    for cfg in fused:
        assert captured_bodies(cfg) == {"ingest", "query", "topk"}
    for cfg in eager:
        assert captured_bodies(cfg) == {"query", "topk"}
    assert not _engine(base, capture=True).capture    # the CPU never does


def test_launch_census_round_trip():
    """A census taken across launches, added back, counts them again:
    what a replay adds for the kernels its graph captured."""
    ops.reset_launch_counts()
    before = ops.launch_census()
    ops.REGISTRY["link_score"].module.launches += 2
    ops.REGISTRY["embed_attn"].module.launches += 1
    from repro_torch.kernels import flash_attn as fa
    fa.launches_by_route["wgmma"] += 3
    delta = ops.launches_since(before)
    assert delta == {"link_score": 2, "embed_attn": 1,
                     ("flash_attn", "wgmma"): 3}
    ops.add_launches(delta, -1)
    assert ops.launch_census() == before
    ops.add_launches(delta, 4)
    assert ops.launch_counts()["link_score"] == 8
    assert fa.launches_by_route["wgmma"] == 12
    ops.reset_launch_counts()
    assert all(v == 0 for v in ops.launch_census().values())


def test_state_cannot_be_rebound_under_a_graph(stream):
    """Re-binding the state works while no graph exists (the eager engine)
    and raises once one does (a graph writes the storage it captured)."""
    eng = _engine(_cfg(stream))
    other = tmdgnn.clone_state(eng.state)
    eng.state = other
    assert eng.state is other
    eng.query(stream.src[:4], stream.dst[:4], stream.t[:4])
    next(iter(eng._slots.values())).graph = object()   # as after capture
    with pytest.raises(RuntimeError, match="captured CUDA graphs"):
        eng.state = tmdgnn.clone_state(other)
    with pytest.raises(RuntimeError, match="captured CUDA graphs"):
        eng.params = dict(eng.params)
    assert eng.state is other


def test_warmup_fold_is_a_no_op(stream):
    """The masked fold that prepares every ingest key leaves the state's
    rows as they were (on the card it is also the eager run before
    capture)."""
    eng = _engine(_cfg(stream))
    eng.ingest(stream.src[:50], stream.dst[:50], stream.t[:50],
               stream.feat[:50])
    before = tmdgnn.clone_state(eng.state)
    z = np.zeros(64, np.int32)
    eng._fold(EventBatch.from_numpy(z, z, np.zeros(64, np.float32),
                                    np.zeros((64, eng.batcher.d_edge),
                                             np.float32),
                                    np.zeros(64, bool), "cpu"))
    assert torch.equal(before["memory"].mem, eng.state["memory"].mem)
    for k in ("nbr", "t", "ptr"):
        assert torch.equal(before["neighbors"][k][:-1],
                           eng.state["neighbors"][k][:-1])
    assert torch.equal(before["pres"].rows().xi, eng.state["pres"].rows().xi)
