#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit from nvidia-smi; exits 2 when
   CUDA is unavailable or the port's sources are not beside this script.
2. build: nvcc builds every kernel under src/repro_torch/kernels/csrc.
3. edge: each CUDA kernel against its plain PyTorch version at edge shapes
   (M=1, ragged tiles, a node group across a block edge, all-masked rows,
   large time gaps).
4. serve at the paper model's widths (tgn_pres CONFIG: d=100, d_time=32,
   K=10, 2 heads, 1 layer) on wiki-small: ServeEngine + replay over the
   serve tail with recommend_topk; the kernel launch counters are zeroed
   just before and read just after, and every kernel must have launched.
   The same replay then runs with kernels_mode="oracle" and the states,
   query scores and top-k are compared.
5. serve at the PRODUCTION widths (d=128, d_time=64, K=16, 2 layers) on the
   first events of the 120,000-node stream-small graph, with the same
   counters and a comparison of queries and top-k against the plain path.
6. kernels: each kernel and its plain version timed (CUDA events, median)
   on the largest inputs it received in one more fold, query and top-k at
   the end of each serve phase (after the counters were read), compared
   there, and set beside the card's bound for that work.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}."""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# each output: |kernel - plain| <= TOL * max(1, max|that plain output|), the
# fp32 sums running in another order; the outputs listed in EXACT (by
# position) are copies, not sums, and must be equal (memory_update_table's
# last_t holds the event times it scatters)
TOL = {"memory_update_table": 1e-5, "embed_attn": 1e-4, "link_score": 1e-4}
EXACT = {"memory_update_table": (1,)}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"memory_update_table": CSRC + "memory_update.cu",
           "embed_attn": CSRC + "embed_attn.cu",
           "link_score": CSRC + "link_score.cu"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def time_ms(fn, reps=None):
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = max(3, min(25, int(0.5 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def work(name, args):
    """(bytes, flops) the call needs on these inputs: each input read once,
    each output written once, counting only the rows and slots the data
    uses (valid gathers, selected writes, valid attention slots). The
    attention's K/V projection is linear, so its table part is counted once
    per distinct referenced row and only its time-encoding part per slot."""
    f = 4
    if name == "memory_update_table":
        table, _, x, g, w_idx, _, w, u, b, dm, _, _ = args
        n, d = table.shape
        din = x.shape[1]
        valid = int((g < n).sum())
        written = int((w_idx < n).sum())
        m = x.shape[0]
        nbytes = (m * (din + d + 4) + (w.numel() + u.numel()
                  + b.numel()) + valid * d + 3 * m * d + written * (d + 1)) * f
        flops = valid * (2 * 3 * d * (din + d) + 20 * d)
        return nbytes, flops
    if name == "embed_attn":
        h_self, tab, idx, dt, valid, tw, _, wq, wk, _ = args
        r, ds = h_self.shape
        din = tab.shape[1]
        kk = idx.shape[1]
        e = wq.shape[1]
        dtime = tw.shape[0]
        nv = int(valid.sum())
        rows = int(idx[valid].unique().numel())
        nbytes = (r * ds + rows * din + r * kk * 2 + 2 * tw.numel()
                  + wq.numel() + 2 * wk.numel() + r * e) * f + r * kk
        flops = (2 * r * ds * e + rows * 4 * din * e
                 + nv * (4 * dtime * e + 4 * e + 2 * dtime))
        return nbytes, flops
    h_src, h_items, w1, b1, w2, _ = args
    nb, d = h_src.shape
    ni = h_items.shape[0]
    nbytes = ((nb + ni) * d + w1.numel() + 2 * d + 1 + nb * ni) * f
    flops = 2 * (nb + ni) * d * d + 5 * nb * ni * d
    return nbytes, flops


def shape_of(name, a):
    if name == "memory_update_table":
        return f"M={a[2].shape[0]} D={a[0].shape[1]} Din={a[2].shape[1]}"
    if name == "embed_attn":
        return (f"R={a[0].shape[0]} K={a[2].shape[1]} U={a[1].shape[0]} "
                f"E={a[7].shape[1]}")
    return f"B={a[0].shape[0]} I={a[1].shape[0]} D={a[0].shape[1]}"


def bound(name, args):
    nbytes, flops = work(name, args)
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def run_pair(name, args, kw):
    """Kernel and plain version on private copies of the inputs (the
    memory-table pass writes its table in place)."""
    from repro_torch.kernels import ops
    fresh = lambda: [a.clone() for a in args]
    got = ops.dispatch(name, *fresh(), mode="compiled", **kw)
    want = ops.dispatch(name, *fresh(), mode="oracle", **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return got, want


def check_kernel(name, args, kw, label):
    """Each output of the kernel against the plain version's, at its own
    scale; returns the largest |kernel - plain| over all outputs."""
    import torch
    got, want = run_pair(name, args, kw)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()),
                f"{name} [{label}]: output {i} is not finite")
        if not g.numel():
            continue
        err = float((g - w).abs().max())
        lim = (0.0 if i in EXACT.get(name, ())
               else TOL[name] * max(1.0, float(w.abs().max())))
        require(err <= lim, f"{name} [{label}]: output {i}: max|kernel - "
                f"plain| = {err:.3g} > {lim:.3g}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: edge shapes
# ---------------------------------------------------------------------------


def edge_cases(dev):
    import numpy as np
    import torch
    from repro_torch.models import mdgnn
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    rng = np.random.default_rng(0)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    cases = []
    for m, n, d, din, mfrac, hot in [(200, 50, 16, 24, 0.0, 70),
                                     (24, 10, 8, 8, 0.4, 0), (1, 5, 8, 8, 0, 0),
                                     (12, 30, 100, 100, 0.2, 3),
                                     (16, 9, 12, 20, 0.1, 5)]:
        nodes = rng.integers(0, n, m)
        if hot:
            nodes[rng.choice(m, hot, replace=False)] = 7 % n
        times = np.round(rng.random(m) * 5).astype(np.float32)
        mask = rng.random(m) >= mfrac
        tn, tt, tm = t(nodes).long(), t(times), t(mask)
        order = mdgnn.occurrence_order(tn, tt, tm)
        sel = mdgnn._last_occurrence_flags(tn, tt, tm)
        gidx = torch.where(tm, tn, n + 1)[order].to(torch.int32)
        widx = torch.where(sel, tn, n)[order].to(torch.int32)
        args = [t(f(n, d, sc=0.5)), t(f(n)), t(f(m, din)), gidx, widx,
                tt[order].contiguous(), t(f(din, 3 * d, sc=din ** -0.5)),
                t(f(d, 3 * d, sc=d ** -0.5)), t(f(3 * d, sc=0.1)),
                t(f(m, d, sc=0.3)),
                t(np.round(rng.random(m) * 3).astype(np.float32)),
                t(np.float32(0.37))]
        cases.append(("memory_update_table", args,
                      dict(clip=1.0, delta_mode="transition"),
                      f"M={m} D={d} Din={din} masked={mfrac} hot={hot}"))
    for r, u, kk, ds, din, dtime, e, heads, bad, dts in [
            (1, 3, 1, 8, 8, 4, 8, 1, 0, 1.0),
            (9, 12, 3, 12, 10, 6, 12, 2, 2, 10.0),
            (37, 50, 16, 128, 128, 64, 128, 2, 3, 1e5),
            (3, 40, 64, 16, 16, 8, 16, 2, 1, 1e3)]:
        valid = rng.random((r, kk)) < 0.7
        valid[:bad] = False
        args = [t(f(r, ds)), t(f(u, din)),
                t(rng.integers(0, u, (r, kk)).astype(np.int32)),
                t((rng.random((r, kk)) * dts).astype(np.float32)), t(valid),
                t(f(dtime)), t(f(dtime)), t(f(ds, e, sc=ds ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5))]
        cases.append(("embed_attn", args, dict(n_heads=heads),
                      f"R={r} K={kk} d={din} heads={heads} dt~{dts:g}"))
    for b, i, d in [(1, 37, 16), (5, 130, 100), (33, 20000, 128)]:
        args = [t(f(b, d)), t(f(i, d)), t(f(2 * d, d, sc=d ** -0.5)),
                t(f(d, sc=0.1)), t(f(d, 1, sc=d ** -0.5)), t(f(1))]
        cases.append(("link_score", args, {}, f"B={b} I={i} D={d}"))
    return cases


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


class Capture:
    """Keeps a copy of the largest inputs each kernel received (the latest
    among equals) while it is entered; the launch goes through unchanged."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = dict(ops.REGISTRY)
        self.best = {}

    @staticmethod
    def size(name, args):
        if name == "memory_update_table":
            return args[2].shape[0]
        if name == "link_score":
            return args[0].shape[0] * args[1].shape[0]
        return args[0].shape[0] * args[2].shape[1]

    def __enter__(self):
        def wrap(name, fn):
            def run(*args, **kw):
                s = self.size(name, args)
                if s >= self.best.get(name, (-1,))[0]:
                    self.best[name] = (s, [a.clone() for a in args], dict(kw))
                return fn(*args, **kw)
            return run
        for name, spec in self.saved.items():
            self.ops.REGISTRY[name] = dataclasses.replace(
                spec, cuda=wrap(name, spec.cuda))
        return self

    def __exit__(self, *exc):
        self.ops.REGISTRY.update(self.saved)


def _compare_states(a, b, label):
    """Rings, times and counts exact; table and tracker sums to 1e-4 (the
    trackers are index_add_ sums whose CUDA atomics order varies). The
    dump rows (last row of rings and trackers) are not state."""
    import torch
    for key in ("nbr", "t", "ptr"):
        require(torch.equal(a["neighbors"][key][:-1],
                            b["neighbors"][key][:-1]),
                f"{label}: neighbour {key} differ")
    require(torch.equal(a["memory"].last_update, b["memory"].last_update),
            f"{label}: last_update differ")
    pa, pb = a["pres"].rows(), b["pres"].rows()
    require(torch.equal(pa.n, pb.n), f"{label}: pres.n differ")
    errs = {}
    for key, x, y, tol in [
            ("memory", a["memory"].mem, b["memory"].mem, 1e-4),
            ("xi", pa.xi, pb.xi, 1e-4), ("psi", pa.psi, pb.psi, 1e-4)]:
        err = float((x - y).abs().max())
        scale = max(1.0, float(y.abs().max()))
        require(err <= tol * scale, f"{label}: {key} differ by {err:.3g}")
        errs[key] = err
    return errs


def _report(label, rep, counts, engine):
    log(f"[{label}] events={rep.n_events} ticks={rep.n_ticks} "
        f"events/s={rep.events_per_sec:.1f} "
        f"ingest p50={rep.ingest_p50_ms:.3f}ms p99={rep.ingest_p99_ms:.3f}ms "
        f"query p50={rep.query_p50_ms:.3f}ms p99={rep.query_p99_ms:.3f}ms "
        f"online_AP={rep.online_ap:.4f}")
    log(f"[{label}] launches {json.dumps(counts)}")
    st = engine.state
    mb = lambda *ts: sum(x.numel() * x.element_size() for x in ts) / 1e6
    log(f"[{label}] state MB: memory={mb(st['memory'].mem):.1f} "
        f"trackers={mb(st['pres'].xi, st['pres'].psi, st['pres'].n):.1f} "
        f"rings={mb(*st['neighbors'].values()):.1f}")


def serve_phase(label, cfg, stream, dst_range, dev, *, rate, tick,
                max_events, query_batch, topk_src, k, oracle_replay,
                big_query, probe, profile=0):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.serve import MicroBatcher, ServeEngine, replay

    def engine(mode):
        c = dataclasses.replace(cfg, kernels_mode=mode)
        params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
        return ServeEngine(c, params, mdgnn.init_state(c, dev),
                           batcher=MicroBatcher(d_edge=stream.feat_dim),
                           item_range=dst_range, device=dev)

    eng = engine("auto")
    eng.warmup(query=True, topk_k=k)
    kw = dict(rate=rate, tick=tick, query_batch=query_batch, seed=0,
              max_events=max_events, warmup=False)
    ops.reset_launch_counts()
    rep = replay(eng, stream, dst_range, **kw)
    q_src, q_dst = stream.src[:big_query], stream.dst[:big_query]
    q_t = np.full(big_query, stream.t[max_events - 1], np.float32)
    scores = eng.query(q_src, q_dst, q_t)
    ts = np.full(len(topk_src), stream.t[max_events - 1], np.float32)
    vals, ids = eng.recommend_topk(topk_src, ts, k)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _report(label, rep, counts, eng)
    require(all(v > 0 for v in counts.values()),
            f"{label}: a kernel of the path never launched: {counts}")
    require(np.isfinite(scores).all() and scores.shape == (big_query,),
            f"{label}: bad query scores")
    require(vals.shape == (len(topk_src), k) and np.isfinite(vals).all()
            and ((ids >= dst_range[0]) & (ids < dst_range[1])).all(),
            f"{label}: bad top-k output")
    require(0.0 <= rep.online_ap <= 1.0, f"{label}: AP out of range")

    plain = engine("oracle")
    if oracle_replay:
        rep_o = replay(plain, stream, dst_range, **kw)
        errs = _compare_states(eng.state, plain.state, label)
        log(f"[{label}] oracle replay: AP={rep_o.online_ap:.4f} "
            f"max|state diff| {json.dumps(errs)}")
        require(abs(rep_o.online_ap - rep.online_ap) <= 1e-3,
                f"{label}: AP {rep.online_ap} vs oracle {rep_o.online_ap}")
    else:
        plain.state = eng.state          # same state, plain kernels
    s_o = plain.query(q_src, q_dst, q_t)
    v_o, _ = plain.recommend_topk(topk_src, ts, k)
    q_err = float(np.abs(scores - s_o).max())
    k_err = float(np.abs(vals - v_o).max())
    log(f"[{label}] vs plain path: max|query diff|={q_err:.3g} "
        f"max|top-k score diff|={k_err:.3g}")
    require(q_err <= 1e-3 * max(1.0, float(np.abs(s_o).max())),
            f"{label}: query scores differ from the plain path by {q_err}")
    require(k_err <= 1e-3 * max(1.0, float(np.abs(v_o).max())),
            f"{label}: top-k scores differ from the plain path by {k_err}")

    # phase 6's inputs: one more fold, query and top-k on the final state,
    # made after the counters were read
    with Capture() as cap:
        hi = max_events + probe
        eng.ingest(stream.src[max_events:hi], stream.dst[max_events:hi],
                   stream.t[max_events:hi], stream.feat[max_events:hi])
        eng.query(q_src, q_dst, q_t)
        eng.recommend_topk(topk_src, ts, k)
        torch.cuda.synchronize()
    if profile:
        _profile(label, eng, stream, max_events + probe, profile, q_src[:64],
                 q_dst[:64], q_t[:64])
    return counts, cap.best


def _profile(label, eng, stream, lo, ticks, q_src, q_dst, q_t):
    """torch.profiler over `ticks` rounds of (64-pair query, then a fold of
    the next 1/ticks of the remaining events): device time by kernel and
    the device busy share of the window's wall time (the profiler's own
    host overhead is inside that wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step = (len(stream) - lo) // ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(ticks):
            a, b = lo + w * step, lo + (w + 1) * step
            eng.query(q_src, q_dst, q_t)
            eng.ingest(stream.src[a:b], stream.dst[a:b], stream.t[a:b],
                       stream.feat[a:b])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries, without the engine's record_function ranges
    # (those span their kernels and the gaps between them)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("serve_")]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[{label}] profile: {ticks} x (query 64 pairs + fold {step} "
        f"events): wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{label}] profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} x {e.key[:90]}")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the result lines as JSON to this file")
    ap.add_argument("--profile", type=int, default=0, metavar="TICKS",
                    help="also profile TICKS query+fold rounds at the end "
                         "of each serve phase")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no output"
    log(card)
    dev = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {len(_build.sources())} sources for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s")

    # 3. edge shapes
    for name, a, kw, label in edge_cases(dev):
        err = check_kernel(name, a, kw, label)
        log(f"[edge] {name} {label}: max_abs_err={err:.3g}")

    # 4. serve at the paper model's widths on wiki-small
    from repro_torch.graph import datasets
    from repro_torch.models.mdgnn import MDGNNConfig
    spec = datasets.SPECS["wiki-small"]
    wiki = datasets.get_dataset("wiki-small", 0)
    _, wiki_serve = wiki.train_serve_split(0.3)
    wiki_dst = (spec.n_users, spec.n_users + spec.n_items)
    cfg = MDGNNConfig(variant="tgn", n_nodes=wiki.num_nodes,
                      d_edge=wiki.feat_dim, d_mem=100, d_msg=100, d_time=32,
                      d_embed=100, n_neighbors=10, n_layers=1, use_pres=True,
                      use_kernels=True)
    main_counts, main_inputs = serve_phase(
        "serve-config", cfg, wiki_serve, wiki_dst, dev, rate=5000.0,
        tick=200 / 5000.0, max_events=5000, query_batch=32,
        topk_src=wiki_serve.src[:8], k=10, oracle_replay=True,
        big_query=1024, probe=200, profile=args.profile)

    # 5. serve at the PRODUCTION widths on the stream-small graph
    sspec = datasets.STREAM_SPECS["stream-small"]
    n_events = 307_200
    stream = datasets.stream_events(sspec, 0, n_events + 11_000)
    s_dst = (sspec.n_users, sspec.num_nodes)
    pcfg = MDGNNConfig(variant="tgn", n_nodes=sspec.num_nodes,
                       d_edge=sspec.feat_dim, d_mem=128, d_msg=128,
                       d_time=64, d_embed=128, n_neighbors=16, n_layers=2,
                       use_pres=True, use_kernels=True)
    prod_counts, prod_inputs = serve_phase(
        "serve-production", pcfg, stream, s_dst, dev, rate=100_000.0,
        tick=1000 / 100_000.0, max_events=n_events, query_batch=32,
        topk_src=stream.src[:16], k=10, oracle_replay=False,
        big_query=1024, probe=1000, profile=args.profile)

    # 6. kernels on the inputs the serve phases handed them
    rows, prod_rows = [], {}
    for name, spec_ in ops.REGISTRY.items():
        for phase, inputs in (("config", main_inputs),
                              ("production", prod_inputs)):
            _, a, kw = inputs[name]
            err = check_kernel(name, a, kw, f"{phase} serve inputs")
            copies = [x.clone() for x in a]
            ms = time_ms(lambda: ops.dispatch(name, *copies, mode="compiled",
                                              **kw))
            plain_ms = time_ms(lambda: ops.dispatch(name, *copies,
                                                    mode="oracle", **kw))
            b_ms, b_by = bound(name, a)
            shape = shape_of(name, a)
            row = {"name": name, "route": "cuda", "source": SOURCES[name],
                   "replaces": spec_.replaces,
                   "launches": (main_counts if phase == "config"
                                else prod_counts)[name],
                   "max_abs_err": err, "tol": TOL[name], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None, "shape": shape}
            log(f"[kernel:{phase}] {json.dumps(row)}")
            if phase == "config":
                rows.append(row)
            else:
                prod_rows[name] = row
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "production": prod_rows},
            indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
