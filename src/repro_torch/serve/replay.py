"""Replay harness (counterpart of `repro/serve/replay.py`): drive a
ServeEngine from a timestamped stream under a Poisson arrival clock,
score-then-fold per service tick.

Each tick samples positive queries from its not-yet-folded events, pairs
them with corrupted-destination negatives, scores both, then ingests the
tick's events. Every engine call is timed to a device sync, so p50/p99 are
end-to-end serving latencies and events/sec is synchronous throughput.
`post_warmup_traces` lists the keys the engine prepared during the replay
(on CUDA: captured a graph for), which a warmed-up engine never does."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.graph import events as events_lib
from repro_torch.graph.events import EventStream
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils import metrics as metrics_lib


@dataclasses.dataclass
class ReplayReport:
    n_events: int            # events folded into the memory
    n_queries: int           # candidate pairs scored (positives + negatives)
    n_ticks: int             # service windows driven
    seconds: float           # end-to-end wall clock (after warm-up)
    events_per_sec: float
    queries_per_sec: float
    ingest_p50_ms: float
    ingest_p99_ms: float
    query_p50_ms: float
    query_p99_ms: float
    online_ap: float         # AP over the sampled (pos, neg) query pairs
    sim_seconds: float       # simulated arrival-clock span
    # keys the engine prepared DURING the replay (after warm-up), as
    # {(kind, bucket[, k]): count}: non-empty means a live request paid a
    # capture and the percentiles above include it
    post_warmup_traces: dict = dataclasses.field(default_factory=dict)


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64) * 1e3, q)) if xs \
        else 0.0


def replay(engine: ServeEngine, stream: EventStream, dst_range, *,
           rate: float = 5000.0, tick: float = 0.02, query_batch: int = 32,
           seed: int = 0, late_frac: float = 0.0, max_late: int = 0,
           max_events: int | None = None, warmup: bool = True) -> ReplayReport:
    """Replay `stream` through `engine` and measure serving behaviour
    (same arguments and sampling as the JAX harness, so the same stream and
    seed give the same queries)."""
    if max_events is not None:
        stream = stream.slice(0, min(max_events, len(stream)))
    n = len(stream)
    if n == 0:
        raise ValueError("replay needs a non-empty serve stream")
    rng = np.random.default_rng(seed)
    arrival = events_lib.poisson_arrival_clock(n, rate, seed)
    if late_frac > 0.0 and max_late > 0:
        stream = stream.reorder(
            events_lib.late_arrival_order(n, late_frac, max_late, seed + 1))
    n_ticks = int(np.ceil(arrival[-1] / tick))
    bounds = np.searchsorted(arrival, np.arange(1, n_ticks + 1) * tick)
    bounds = np.concatenate([[0], bounds])

    if warmup:
        engine.warmup(query=True)
    warm_traces = dict(engine.trace_counts)

    ingest_times, query_times = [], []
    pos_scores, neg_scores = [], []
    n_queries = 0
    t0 = time.perf_counter()
    for w in range(n_ticks):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        if hi <= lo:
            continue
        q = min(query_batch, hi - lo)
        if q > 0:
            pick = lo + rng.choice(hi - lo, q, replace=False)
            q_src = stream.src[pick]
            q_dst = stream.dst[pick]
            q_t = stream.t[pick]
            neg_dst = rng.integers(dst_range[0], dst_range[1],
                                   q).astype(np.int32)
            tq = time.perf_counter()
            scores = engine.query(np.concatenate([q_src, q_src]),
                                  np.concatenate([q_dst, neg_dst]),
                                  np.concatenate([q_t, q_t]))
            query_times.append(time.perf_counter() - tq)
            pos_scores.append(scores[:q])
            neg_scores.append(scores[q:])
            n_queries += 2 * q
        ti = time.perf_counter()
        engine.ingest(stream.src[lo:hi], stream.dst[lo:hi], stream.t[lo:hi],
                      stream.feat[lo:hi])
        engine.block_until_ready()
        ingest_times.append(time.perf_counter() - ti)
    seconds = time.perf_counter() - t0

    ap = (metrics_lib.average_precision(np.concatenate(pos_scores),
                                        np.concatenate(neg_scores))
          if pos_scores else 0.0)
    return ReplayReport(
        n_events=n, n_queries=n_queries, n_ticks=n_ticks, seconds=seconds,
        events_per_sec=n / seconds if seconds > 0 else 0.0,
        queries_per_sec=n_queries / seconds if seconds > 0 else 0.0,
        ingest_p50_ms=_pctl(ingest_times, 50),
        ingest_p99_ms=_pctl(ingest_times, 99),
        query_p50_ms=_pctl(query_times, 50),
        query_p99_ms=_pctl(query_times, 99),
        online_ap=ap, sim_seconds=float(arrival[-1]),
        post_warmup_traces={
            k: c - warm_traces.get(k, 0)
            for k, c in engine.trace_counts.items()
            if c > warm_traces.get(k, 0)})
