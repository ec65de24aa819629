#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE] [--profile TICKS] [--only PHASES]

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit from nvidia-smi; exits 2 when
   CUDA is unavailable or the port's sources are not beside this script.
2. build: nvcc builds every kernel under src/repro_torch/kernels/csrc;
   ptxas's registers, spills and shared memory for each instantiation of
   the bf16 flash_attn kernel, whose SASS must hold wgmma (HGMMA) and TMA
   loads (UTMALDG), and of gru_cell, embed_attn, memory_update (the table
   kernel and the dense memory_update), ssd_chunk and link_score, whose
   SASS must hold mma.sync (HMMA: their 3xTF32 products).
3. edge: each CUDA kernel against its plain PyTorch version at edge shapes
   (M=1, ragged tiles, a node group across a block edge, all-masked rows,
   large time gaps, D % 4 != 0, a misaligned start, K = 1, the K and E
   limits, Din != D, clip bounds hit exactly, both PRES delta modes; for
   gru_cell M at its 64-row tile +- 1, D = 100 with Din = 172 and odd
   widths (its 4-byte copies); for
   embed_attn CONFIG's E = 100 with 2 heads at K = 10, R off its 32-row
   tile at PRODUCTION widths, one table row shared by most slots; for
   flash_attn S = 1, ragged S, T != S, windows, n_rep 1/2/3/4, D 16 to
   256 (80, 96: not multiples of 64; 20: not of 8), S = 8,192, fp32 (the
   FMA kernel) and bf16 (the wgmma kernel, held within one bf16 ulp of
   the fp32 plain version);
   for ssd_chunk L = 1, ragged L, L = 64 and 65, N = 256 with P = 257 at
   G = 1 and 8, P = 8 and 264, a large negative lcum, G = 3 with groups
   of v and h0 off 16-byte boundaries (L P and N P odd); for the table kernel
   M = 2,048 at D = Din = 128 with a hot node across a 64-row tile edge
   and masked rows on tiles' first and last rows, M = 65, Din = 20 with
   D = 12 (its 4-byte copies) across tiles; for link_score D = 21 (its
   4-byte copies), B = 1 with h_items the engine's h[B:] view 84 bytes
   into its buffer, I at its 80- and 160-item blocks +- 1 and at the
   switch between them, B = 17 and 1,024 at I = 20,000, D = 128, and
   D = 172).
4. serve-config at the paper model's widths (tgn_pres.CONFIG: d=100,
   d_time=32, K=10, 2 heads, 1 layer) on wiki-small: ServeEngine + replay
   over the serve tail with recommend_topk, the engine as users get it:
   warmup() captures a CUDA graph per bucket for the bodies
   `captured_bodies(cfg)` names (query and top-k always, the fold where
   the memory stage is the memory_update_table kernel), and every key must
   be prepared once, with nothing prepared during the replay
   (post_warmup_traces empty). The same replay then runs through a
   capture=False engine (events/s, p50/p99, peak memory side by side; AP
   within 1e-3, states within `_compare_states`' tolerances, the same
   launch counts: a replay adds its graph's launches, counted at capture),
   and with kernels_mode="oracle"; the states, query scores and top-k are
   compared.
5. serve-production at the PRODUCTION widths (d=128, d_time=64, K=16, 2
   layers) on the first events of the 120,000-node stream-small graph,
   with a comparison of queries and top-k against the plain path.
   serve-config-apan / serve-production-apan: the same for APAN (mailbox
   attention through neighbor_attn); serve-config-rnn /
   serve-production-rnn: the rnn memory cell, PRES through pres_filter
   (its fold stays eager: mdgnn.memory_update waits for the host);
   serve-config-jodie / serve-production-jodie: JODIE with PRES (its time
   projection has no kernel: memory_update_table and link_score).
   serve-parity: serve/parity.py's gate, the captured engine against
   loop.make_eval_step in lock step over wiki-small's first 6,400 events
   (buckets 16 and 64), within 1e-5, each key prepared once.
6. train-config-pres / -std: Alg. 2 (PRES) and Alg. 1 (the gru_cell
   kernel) at CONFIG widths on wiki-small, one epoch (27 lag-one steps at
   b=500) through the epoch loop, then loop.evaluate over the validation
   split; then the same epoch from the same start and negatives through
   the kernels and with kernels_mode="oracle", both under deterministic
   algorithms, compared free-running and step by step.
   train-config-pipe (the pipelined schedule at depth 1, then at depth 2,
   pres_predict on every step), -dense (TGN's dense expansion,
   neighbor_attn), -apan (APAN), -rnn (the rnn cell with PRES: the cell,
   then pres_filter), -rnn-std (the rnn cell, Alg. 1) and -time (PRES
   with the paper's t2 - t1 scale and the mean aggregator, pipelined at
   depth 2), -jodie (JODIE, Alg. 2) and -jodie-std (JODIE, Alg. 1:
   gru_cell), -buckets (PRES with hashed trackers, pres_buckets = |V| /
   16) and -pipe-buckets (the same pipelined at depth 2: pres_predict on
   the bucket means) the same. train-config-plain: TGN-PRES with
   use_kernels=False, the reference's plain route, which must launch no
   kernel, held free-running and step by step against train-config-pres's
   kernel route. After train-config-pres (and -production-pres),
   op-memory-update drives the dense registry op `ops.memory_update`,
   which the model never calls (nor does the JAX package's), forward and
   backward on that phase's occurrence rows.
7. cli: both algorithms for one epoch through the training CLI
   (`python -m repro_torch.launch.train`, its default device); cli-new:
   the CLI with --pipeline-depth 2, --no-dedup-embed and --model apan;
   cli-time: with --pres-scale time; cli-jodie: --model jodie; cli-plain:
   without --use-kernels (no launch); cli-ckpt: the train CLI with
   --checkpoint, then the serve CLI with --checkpoint on the file, and an
   engine restored from it against one built from the trainer's own
   params and state (query scores within TOL); cli-csv: the train CLI with
   --csv tests/data/mini_jodie.csv.
8. train-production-pres / -std / -pipe / -dense / -apan / -rnn / -jodie:
   40 steps at PRODUCTION widths on the first 41,000 stream-small events
   (b=1000), the first 3 steps' losses compared with the plain path; step
   time, events/s and peak device memory.
9. zoo-qwen3 / zoo-xlstm: the model zoo's prefill at full width (qwen3-0.6b
   at B=2, S=8192; xlstm-350m at B=2, S=2048; random weights and tokens
   from --seed) in float32 through the kernels, counted (flash_attn once a
   layer, 28, all on its fp32 route; ssd_chunk once a chunk and mLSTM
   layer, 168), against the plain route; then timed in the published
   bfloat16 (tokens/s, peak memory; flash_attn's launches all on its bf16
   wgmma route) and 16 greedy decode steps against an S-slot cache (ms a step;
   decode launches no kernel). cli-zoo: `python -m repro_torch.launch.serve
   --zoo` for both archs.
10. kernels: each kernel and its plain version timed (CUDA events around
   the Python call, median: `ms`, host work included where the card waits
   for it; and `device_ms`, the kernel's own CUDA time a call from
   torch.profiler)
   on the largest inputs it received in the phase that captured them (the
   serve phases' probe, through the eager engine, after their counters
   were read; gru_cell during
   the Alg. 1 train phases; pres_predict, neighbor_attn, pres_filter and
   memory_update in a probe of their train phases' path on the trained
   state; flash_attn and ssd_chunk in the zoo's bf16 prefill), compared
   there, set beside the card's bound for that work (`work`) and,
   where one PyTorch call computes the same function, beside that call's
   time, by events and on the device (memory_update also beside gru_cell
   then pres_filter; flash_attn with the route that ran, its products'
   TFLOP/s and its share of the bound; embed_attn with its route, the
   fold, the U of its shape and the bound of the form before the fold).

Every serve, train and zoo phase names the kernels its path must launch;
any other kernel launched fails it. The launch counters are zeroed just
before the phase drives its path and read just after, and the memory
stage's kernel must have launched once a step or fold. `--only` runs some
phases; with no arguments it runs them all.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
# and dense bf16 and TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# each output: |kernel - plain| <= TOL * max(1, max|that plain output|), the
# fp32 sums running in another order; the outputs listed in EXACT (by
# position) are copies, not sums, and must be equal (memory_update_table's
# last_t holds the event times it scatters; pres_predict's and pres_filter's
# products, sums and quotient round one by one as the plain version's
# separate kernels do, so their outputs are held exactly too)
TOL = {"memory_update_table": 1e-5, "embed_attn": 1e-4, "link_score": 1e-4,
       "gru_cell": 1e-5, "pres_predict": 0.0, "neighbor_attn": 1e-4,
       "pres_filter": 0.0, "memory_update": 1e-5, "flash_attn": 1e-5,
       "ssd_chunk": 1e-5}
EXACT = {"memory_update_table": (1,), "pres_predict": (0,),
         "pres_filter": (0, 1)}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"memory_update_table": CSRC + "memory_update.cu",
           "embed_attn": CSRC + "embed_attn.cu",
           "link_score": CSRC + "link_score.cu",
           "gru_cell": CSRC + "gru_cell.cu",
           "pres_predict": CSRC + "pres_predict.cu",
           "neighbor_attn": CSRC + "neighbor_attn.cu",
           "pres_filter": CSRC + "pres_filter.cu",
           "memory_update": CSRC + "memory_update.cu",
           "flash_attn": CSRC + "flash_attn_wgmma.cu",
           "ssd_chunk": CSRC + "ssd_chunk.cu"}
# flash_attn's two kernels by route: fp32 inputs on the FMA units, bf16
# inputs on the tensor cores (wgmma fed by TMA)
FLASH_SOURCES = {"fma": CSRC + "flash_attn.cu",
                 "wgmma": CSRC + "flash_attn_wgmma.cu"}
# the model zoo's kernels (prefill only) and the full-width prefill each
# zoo phase drives: batch, sequence, and the launches of its kernel (one
# per layer for qwen3's 28 attention layers, one per chunk for xlstm's 21
# mLSTM layers over 8 chunks of 256)
ZOO_KERNELS = ("flash_attn", "ssd_chunk")
ZOO = {"zoo-qwen3": ("qwen3-0.6b", "flash_attn", 2, 8192, 28),
       "zoo-xlstm": ("xlstm-350m", "ssd_chunk", 2, 2048, 21 * 8)}
# the zoo's last-position prefill logits, kernel route against the plain
# route, both float32: |kernel - plain| <= ZOO_TOL * max(1, max|plain|)
ZOO_TOL = 1e-4
SERVE_KERNELS = ("memory_update_table", "embed_attn", "link_score")
APAN_SERVE_KERNELS = ("memory_update_table", "neighbor_attn", "link_score")
RNN_SERVE_KERNELS = ("pres_filter", "embed_attn", "link_score")
# JODIE's embedding is a plain projection: no embedding kernel
JODIE_SERVE_KERNELS = ("memory_update_table", "link_score")
# training against the plain route. Per step, from the same state: loss,
# logits and memory table within fp32 sums in another order. The first
# moments (0.1 x the gradients) are held at 1e-2 of their largest entry as
# one vector and each leaf at 5e-2 of its own: a dropped or misrouted
# gradient path is off by all of itself, while rounding-level differences
# give about 1e-6, except where a pre-activation lies within rounding of a
# ReLU's kink: the two routes then take different sides and one row's
# share of a weight's gradient moves (measured by this script on the H100:
# up to 3.9e-3 of the embedding's output projection over the 27 steps of
# train-config-pres). Free-running over an epoch: train and val AP (the
# routes drift apart chaotically past the first steps, see train_phase;
# both run under deterministic algorithms, so the gap is the same in every
# run of the same code).
STEP_TOL = {"loss": 1e-5, "logits": 1e-4, "memory": 1e-5, "moments": 1e-2,
            "moments_leaf": 5e-2}
AP_LIMIT = 2e-2


# --profile windows, run after the kernel rows: on the H100 a profiler
# session that follows such windows in the same process drops kernels,
# and the rows' device_ms come from sessions of their own
DEFERRED_PROFILES = []
# label -> the window's wall ms, device busy ms and share, launches
PROFILES = {}


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


def device_ms(fn, reps=5, tries=4, by_kernel=None):
    """The device time of fn() in ms a call: the CUDA kernels (and copies)
    torch.profiler records over `reps` calls after a warm-up, summed and
    divided by the calls. Unlike `time_ms`, whose events bracket the
    Python call and so take in the host's work when the card waits for it,
    this counts only the card's own time. A session must record the same
    number of kernels for every call. Late in a long run on the H100,
    sessions now and then record none, in bursts (a fresh process never
    did in 400 sessions), so a session that does not is run again after a
    pause with twice the calls, up to `tries` times; then the measurement
    is reported missing (None) rather than failing the run, since it
    checks nothing about the kernel. `by_kernel`, a dict, receives each
    kernel's own ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        calls = reps << attempt
        if attempt:
            time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n >= calls and n % calls == 0:
            if by_kernel is not None:
                by_kernel.update({e.key: e.self_device_time_total / calls
                                  / 1e3 for e in events})
            return sum(e.self_device_time_total for e in events) / calls / 1e3
    log(f"[device_ms] torch.profiler recorded {n} kernels in {calls} calls "
        f"after {tries} sessions: device_ms not measured")
    return None


def attn_pairs(s, t, causal, window):
    """(query, key) pairs the causal / window mask leaves valid."""
    import numpy as np
    i = np.arange(s)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(name, args, kw=None):
    """(bytes, flops) the call needs on these inputs, flops either a count
    at the fp32 peak or {peak: count}: each input read once,
    each output written once, counting only the rows and slots the data
    uses (valid gathers, selected writes, valid attention slots or pairs).
    fp32 matrix products that run on the tensor cores (gru_cell's,
    memory_update_table's and memory_update's gate products, ssd_chunk's
    four, embed_attn's per-row ones and link_score's two factors) count
    three TF32 products each at the TF32 peak: the least tensor-core work
    that keeps fp32 grade (one rounding misses TOL); `fp32_flops` keeps
    the count of the first three and link_score at the fp32 peak.
    embed_attn counts the form its kernel takes at every shape, the fold
    (q into Wk and the softmax's weighted sum into Wv, per row with a valid
    slot; 2 H c multiply-adds and the time encoding per valid slot);
    `direct_work` keeps the count of the form before it (K/V projected per
    slot, the table part once per distinct row)."""
    kw = kw or {}
    f = 4
    if name == "flash_attn":
        # q k and p v (2 FLOPs a multiply-add, D each) and the softmax's
        # scale, max, exp and sum on each valid pair. With bf16 inputs the
        # products may run on bf16 tensor cores (q k exactly, with fp32
        # accumulation; p v as a bf16 flash kernel does: the wgmma kernel's
        # second product for p's low part is its own cost, not the
        # algorithm's), the softmax on the fp32 units beside them
        import torch
        q, k, _ = args
        g, s, d = q.shape
        gkv, t = k.shape[:2]
        pairs = attn_pairs(s, t, kw.get("causal", True), kw.get("window"))
        nbytes = (2 * g * s * d + 2 * gkv * t * d) * q.element_size()
        if q.dtype == torch.bfloat16:
            return nbytes, {PEAK_BF16: g * pairs * 4 * d,
                            PEAK_FP32: g * pairs * 4}
        return nbytes, g * pairs * (4 * d + 4)
    if name == "ssd_chunk":
        # per group: q k^T on the L(L+1)/2 pairs j <= i (2N) and their
        # product with v (2P), the carry-in (q * exp(lcum)) h0 and the state
        # update (k * w)^T v (2LNP each); the decays (2 a pair), the
        # scalings (4LN) and exp(ltot) h0 + (2NP) on the fp32 units
        q, _, v, _, _ = args
        g, ll, n = q.shape
        p = v.shape[2]
        tri = ll * (ll + 1) // 2
        nbytes = g * (2 * ll * n + 2 * ll * p + ll + 2 * n * p) * f
        return nbytes, {
            PEAK_TF32: 3 * g * (tri * (2 * n + 2 * p) + 4 * ll * n * p),
            PEAK_FP32: g * (2 * tri + 4 * ll * n + 2 * n * p)}
    if name == "memory_update_table":
        # x W on every occurrence, h U on the valid gathers; the gates and
        # the filter (20 D and 10 D an occurrence) on the fp32 units
        table, _, x, g, w_idx, _, w, u, b = args[:9]
        n, d = table.shape
        m, din = x.shape
        valid = int((g < n).sum())
        written = int((w_idx < n).sum())
        nbytes = (m * (din + d + 4) + (w.numel() + u.numel()
                  + b.numel()) + valid * d + 3 * m * d + written * (d + 1)) * f
        return nbytes, {
            PEAK_TF32: 3 * 2 * 3 * d * (m * din + valid * d),
            PEAK_FP32: m * 30 * d}
    if name == "embed_attn":
        h_self, tab, _, _, valid, tw, _, wq, _, _ = args
        ds = h_self.shape[1]
        e = wq.shape[1]
        c = tab.shape[1] + tw.shape[0]
        heads = kw.get("n_heads", 1)
        live = int(valid.any(1).sum())
        nv = int(valid.sum())
        # per live row: q (ds x E), a_h = Wk_h q_h (E x c), g_h Wv_h
        # (c x E); per valid slot: scores and weighted sum (2 H c each),
        # the angle and cosine, the softmax's max, exp and sum per head
        return direct_work(args)[0], {
            PEAK_TF32: 3 * live * 2 * e * (ds + 2 * c),
            PEAK_FP32: nv * (4 * heads * c + 2 * tw.shape[0] + 4 * heads)}
    if name == "link_score":
        # the factors (B + I rows x D x D) on the tensor cores; the pair
        # pass (the add of the factors and b1, the max, the product with
        # w2 and its sum: 5 a pair-depth element) on the fp32 units
        h_src, h_items, w1, b1, w2, _ = args
        nb, d = h_src.shape
        ni = h_items.shape[0]
        nbytes = ((nb + ni) * d + w1.numel() + 2 * d + 1 + nb * ni) * f
        return nbytes, {PEAK_TF32: 3 * 2 * (nb + ni) * d * d,
                        PEAK_FP32: 5 * nb * ni * d}
    if name == "gru_cell":
        x, h, w, u, b = args
        m, din = x.shape
        d = h.shape[1]
        nbytes = (m * (din + 2 * d) + w.numel() + u.numel() + b.numel()) * f
        return nbytes, {PEAK_TF32: 3 * m * 2 * 3 * d * (din + d),
                        PEAK_FP32: m * 20 * d}
    if name == "pres_predict":
        s_prev, _, _ = args
        m, d = s_prev.shape
        return (3 * m * d + m) * f, 4 * m * d   # mul, max, min, add
    if name == "neighbor_attn":
        # the rows with a valid slot read q, and the valid slots their k
        # and v rows (2 FLOPs an element for the score, 2 for the sum)
        q, k, _, valid = args
        m, e = q.shape
        kk = k.shape[1]
        live = int(valid.any(1).sum())
        nv = int(valid.sum())
        nbytes = (live * e + 2 * nv * e + m * e) * f + m * kk
        return nbytes, nv * (4 * e + 8)
    if name == "pres_filter":
        # three (M, D) rows read, two written, dt and gamma; a multiply,
        # clamp and add (Eq. 7), two multiplies and an add (Eq. 8), a
        # subtract, max and divide (Eq. 9) an element
        s_prev = args[0]
        m, d = s_prev.shape
        return (5 * m * d + m + 1) * f, 10 * m * d
    if name == "memory_update":
        x, h, w, u, b = args[:5]
        m, din = x.shape
        d = h.shape[1]
        nbytes = (m * (din + 5 * d + 1) + w.numel() + u.numel() + b.numel()
                  + 1) * f
        return nbytes, {
            PEAK_TF32: 3 * m * 2 * 3 * d * (din + d), PEAK_FP32: m * 30 * d}
    raise SmokeFailure(f"no work count for kernel {name!r}")


def fp32_flops(name, args):
    """The operations of memory_update_table, memory_update, ssd_chunk and
    link_score with every one at the fp32 peak (the bound `work` gave
    before their products moved to the tensor cores); their bytes are
    `work`'s."""
    if name == "link_score":
        h_src, h_items = args[:2]
        nb, d = h_src.shape
        ni = h_items.shape[0]
        return 2 * (nb + ni) * d * d + 5 * nb * ni * d
    if name == "ssd_chunk":
        q, _, v, _, _ = args
        g, ll, n = q.shape
        p = v.shape[2]
        tri = ll * (ll + 1) // 2
        return g * (tri * (2 * n + 2 + 2 * p) + 4 * ll * n * p
                    + 4 * ll * n + 2 * n * p)
    if name == "memory_update_table":
        table, _, x, g = args[:4]
        n, d = table.shape
        din = x.shape[1]
        return int((g < n).sum()) * (2 * 3 * d * (din + d) + 20 * d)
    if name == "memory_update":
        x, h = args[:2]
        m, din = x.shape
        d = h.shape[1]
        return m * (2 * 3 * d * (din + d) + 20 * d) + 10 * m * d
    raise SmokeFailure(f"no fp32 work count for kernel {name!r}")


def direct_work(args):
    """(bytes, flops) of embed_attn in the form before the fold, all at
    the fp32 peak: q, the K/V projection's table part once per distinct
    referenced row and its time-encoding part per valid slot, the scores
    and weighted sum (the bound `work` gave before the fold)."""
    h_self, tab, idx, _, valid, tw, _, wq, wk, _ = args
    r, ds = h_self.shape
    din = tab.shape[1]
    kk = idx.shape[1]
    e = wq.shape[1]
    dtime = tw.shape[0]
    nv = int(valid.sum())
    rows = int(idx[valid].unique().numel())
    nbytes = (r * ds + rows * din + r * kk * 2 + 2 * tw.numel()
              + wq.numel() + 2 * wk.numel() + r * e) * 4 + r * kk
    flops = (2 * r * ds * e + rows * 4 * din * e
             + nv * (4 * dtime * e + 4 * e + 2 * dtime))
    return nbytes, flops


def shape_of(name, a):
    if name == "flash_attn":
        return (f"G={a[0].shape[0]} Gkv={a[1].shape[0]} S={a[0].shape[1]} "
                f"T={a[1].shape[1]} D={a[0].shape[2]} "
                f"{str(a[0].dtype).replace('torch.', '')}")
    if name == "ssd_chunk":
        return (f"G={a[0].shape[0]} L={a[0].shape[1]} N={a[0].shape[2]} "
                f"P={a[2].shape[2]}")
    if name == "memory_update_table":
        return f"M={a[2].shape[0]} D={a[0].shape[1]} Din={a[2].shape[1]}"
    if name == "memory_update":
        return f"M={a[0].shape[0]} D={a[1].shape[1]} Din={a[0].shape[1]}"
    if name == "pres_filter":
        return f"M={a[0].shape[0]} D={a[0].shape[1]}"
    if name == "embed_attn":
        return (f"R={a[0].shape[0]} K={a[2].shape[1]} U={a[1].shape[0]} "
                f"E={a[7].shape[1]}")
    if name == "gru_cell":
        return f"M={a[0].shape[0]} D={a[1].shape[1]} Din={a[0].shape[1]}"
    if name == "pres_predict":
        return f"M={a[0].shape[0]} D={a[0].shape[1]}"
    if name == "neighbor_attn":
        return (f"M={a[0].shape[0]} K={a[1].shape[1]} E={a[0].shape[1]} "
                f"valid={float(a[3].float().mean()):.3f}")
    return f"B={a[0].shape[0]} I={a[1].shape[0]} D={a[0].shape[1]}"


def check_launches(label, counts, expect):
    """The phase's path launched every kernel of `expect` and no other."""
    log(f"[{label}] launches {json.dumps(counts)}")
    require(all(counts[k] > 0 for k in expect),
            f"{label}: a kernel of the path never launched: {counts}")
    require(all(v == 0 for k, v in counts.items() if k not in expect),
            f"{label}: a kernel off the path launched: {counts}")


def memory_stage_kernel(cfg):
    """The kernel the memory stage of `cfg` launches once per step or
    fold, or None (the rnn cell without PRES is plain PyTorch, and the
    plain route, use_kernels=False, launches no kernel)."""
    if not cfg.use_kernels:
        return None
    if cfg.use_pres:
        return "memory_update_table" if cfg.memory_cell == "gru" \
            else "pres_filter"
    return "gru_cell" if cfg.memory_cell == "gru" else None


def bound(name, args, kw=None):
    """The least ms the card could take: bytes over the memory rate or
    the operations of the slowest unit over its peak, the larger."""
    nbytes, flops = work(name, args, kw)
    if not isinstance(flops, dict):
        flops = {PEAK_FP32: flops}
    tb = nbytes / PEAK_BYTES * 1e3
    tf = max(n / peak * 1e3 for peak, n in flops.items())
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def run_pair(name, args, kw):
    """Kernel and plain version on the inputs, private copies for the
    memory-table pass (it writes its table in place); the others get the
    tensors as given (an edge case's misaligned view stays misaligned)."""
    from repro_torch.kernels import ops
    fresh = lambda: ([a.clone() for a in args]
                     if name == "memory_update_table" else list(args))
    got = ops.dispatch(name, *fresh(), mode="compiled", **kw)
    want = ops.dispatch(name, *fresh(), mode="oracle", **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return got, want


def check_kernel(name, args, kw, label):
    """Each output of the kernel against the plain version's, at its own
    scale; returns the largest |kernel - plain| over all outputs. A bf16
    output is held within one bf16 ulp (plus the fp32 tolerance) of the
    plain version computed in fp32 from the same (bf16) inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bf16_excess
    got, want = run_pair(name, args, kw)
    torch.cuda.synchronize()
    if got[0].dtype == torch.bfloat16:
        want32 = ops.dispatch(name, *[a.float() for a in args],
                              mode="oracle", **kw)
        require(bool(torch.isfinite(got[0].float()).all()),
                f"{name} [{label}]: output is not finite")
        excess, err = bf16_excess(got[0], want32, TOL[name])
        require(excess <= 0, f"{name} [{label}]: bf16 output beyond one ulp "
                f"of the fp32 plain version (max|diff| {err:.3g})")
        return err
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


# the sources whose SASS must hold tensor-core products: HGMMA (wgmma) and
# TMA loads (UTMALDG) for the bf16 flash_attn, HMMA (mma.sync) for the
# 3xTF32 products of gru_cell, embed_attn, memory_update (the table kernel
# and the dense memory_update), ssd_chunk and link_score (its factors)
TENSOR_CORE_SASS = {"flash_attn_wgmma": ("HGMMA", "UTMALDG"),
                    "gru_cell": ("HMMA",), "embed_attn": ("HMMA",),
                    "memory_update": ("HMMA",), "ssd_chunk": ("HMMA",),
                    "link_score": ("HMMA",)}


def check_tensor_core_build(out_dir):
    """For each source of TENSOR_CORE_SASS, print ptxas's registers,
    shared memory, spills (and any wgmma it serialized: none should be)
    for each instantiation, and require its SASS to hold the instructions
    listed there."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    for stem, need in TENSOR_CORE_SASS.items():
        for line in (out_dir / f"{stem}.log").read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "Performance Loss")):
                log(f"[build] ptxas {stem}: {line.strip()}")
        sass = subprocess.run([str(tool), "-sass", str(out_dir /
                                                   f"{stem}.o")],
                              capture_output=True, text=True,
                              timeout=120).stdout
        ops_ = {op: sass.count(op) for op in need}
        log(f"[build] {stem} SASS: {json.dumps(ops_)}")
        require(all(ops_.values()), f"{stem}.o lacks tensor-core (or TMA) "
                f"instructions: {ops_}")


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
    # memory_update_table: a hot node, masked rows, M = 1, Din != D; M at
    # the kernel's 64-row tile + 1, M = 2,048 at PRODUCTION widths with the
    # hot node's 150 occurrences across a tile edge and masked rows on
    # tiles' first and last rows (`edge_rows`), widths off its 16-byte
    # copies (D = 12, Din = 20) over three tiles
    for m, n, d, din, mfrac, hot, edge_rows in [
            (200, 50, 16, 24, 0.0, 70, ()), (24, 10, 8, 8, 0.4, 0, ()),
            (1, 5, 8, 8, 0, 0, ()), (12, 30, 100, 100, 0.2, 3, ()),
            (16, 9, 12, 20, 0.1, 5, ()), (65, 40, 128, 128, 0.1, 9, ()),
            (2048, 500, 128, 128, 0.05, 150, (0, 63, 64, 127, 2047)),
            (150, 60, 12, 20, 0.1, 20, (0, 63, 64))]:
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
        gidx[list(edge_rows)] = n + 1
        widx[list(edge_rows)] = n
        args = [t(f(n, d, sc=0.5)), t(f(n)), t(f(m, din)), gidx, widx,
                tt[order].contiguous(), t(f(din, 3 * d, sc=din ** -0.5)),
                t(f(d, 3 * d, sc=d ** -0.5)), t(f(3 * d, sc=0.1)),
                t(f(m, d, sc=0.3)),
                t(np.round(rng.random(m) * 3).astype(np.float32)),
                t(np.float32(0.37))]
        cases.append(("memory_update_table", args,
                      dict(clip=1.0, delta_mode="transition"),
                      f"M={m} D={d} Din={din} masked={mfrac} hot={hot} "
                      f"masked_rows={list(edge_rows)}"))
    # embed_attn: R = 1 with K = 1, all-invalid rows, dt to 1e5, K = 64;
    # CONFIG's E = 100 with 2 heads at K = 10 (dh = 50, c = 132: not
    # multiples of 8), R not a multiple of the kernel's 32-row tile at
    # PRODUCTION widths, one row of tab shared by most slots
    for r, u, kk, ds, din, dtime, e, heads, bad, dts, hot in [
            (1, 3, 1, 8, 8, 4, 8, 1, 0, 1.0, 0.0),
            (9, 12, 3, 12, 10, 6, 12, 2, 2, 10.0, 0.0),
            (37, 50, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
            (3, 40, 64, 16, 16, 8, 16, 2, 1, 1e3, 0.0),
            (200, 150, 10, 100, 100, 32, 100, 2, 5, 1e5, 0.0),
            (65, 300, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
            (96, 500, 16, 128, 128, 64, 128, 2, 0, 1e3, 0.9)]:
        valid = rng.random((r, kk)) < 0.7
        valid[:bad] = False
        idx = rng.integers(0, u, (r, kk)).astype(np.int32)
        idx[rng.random((r, kk)) < hot] = 7 % u
        args = [t(f(r, ds)), t(f(u, din)), t(idx),
                t((rng.random((r, kk)) * dts).astype(np.float32)), t(valid),
                t(f(dtime)), t(f(dtime)), t(f(ds, e, sc=ds ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5))]
        cases.append(("embed_attn", args, dict(n_heads=heads),
                      f"R={r} K={kk} d={din} E={e} heads={heads} dt~{dts:g} "
                      f"hot={hot}"))
    # link_score: B = 1, ragged tiles, 33 sources (three source tiles);
    # D = 21 (rows off 16 bytes and the depth off the 8-deep mma step);
    # B = 1 at D = 21 with h_items = h[B:] as the engine slices it (84
    # bytes into its buffer); I one under and one over the 80-item block
    # and (I = 20,000 is 125 of them) the 160-item one, there with D = 21
    # too; I at the switch between the two on a 132-SM card; B = 17 and
    # 1,024 at the top-k shape (more source tiles, then several a block);
    # D = 172 (two column passes) with each block shape
    for b, i, d, view in [(1, 37, 16, False), (5, 130, 100, False),
                          (33, 20000, 128, False), (5, 130, 21, False),
                          (1, 37, 21, True), (16, 79, 128, False),
                          (16, 81, 128, False), (16, 19999, 128, False),
                          (16, 20001, 21, False), (16, 10560, 128, False),
                          (16, 10561, 128, False), (17, 20000, 128, False),
                          (1024, 20000, 128, False), (16, 300, 172, False),
                          (8, 20001, 172, False)]:
        if view:
            h = t(f(b + i, d))
            hs, hi = h[:b], h[b:]
        else:
            hs, hi = t(f(b, d)), t(f(i, d))
        args = [hs, hi, t(f(2 * d, d, sc=d ** -0.5)), t(f(d, sc=0.1)),
                t(f(d, 1, sc=d ** -0.5)), t(f(1))]
        cases.append(("link_score", args, {},
                      f"B={b} I={i} D={d}"
                      + (f" h_items at +{hi.storage_offset() * 4} bytes"
                         if view else "")))
    # gru_cell: M = 1, ragged tiles, the CONFIG and PRODUCTION widths, M
    # at the kernel's 64-row tile +- 1, D = 100 (not a multiple of its
    # 16-column tile) with Din = 172, widths off its 16-byte copies
    for m, d, din in [(1, 8, 8), (37, 16, 24), (1000, 100, 100),
                      (2000, 128, 128), (63, 128, 128), (65, 128, 128),
                      (129, 100, 172), (45, 21, 37)]:
        args = [t(f(m, din)), t(f(m, d, sc=0.5)),
                t(f(din, 3 * d, sc=din ** -0.5)), t(f(d, 3 * d, sc=d ** -0.5)),
                t(f(3 * d, sc=0.1))]
        cases.append(("gru_cell", args, {}, f"M={m} D={d} Din={din}"))
    # pres_predict: M = 1, ragged M, D % 4 != 0 (the scalar loop), a
    # misaligned start (the scalar loop again), counts of 0 included
    for m, d, off in [(1, 8, 0), (37, 12, 0), (50, 7, 0), (999, 100, 0),
                      (64, 16, 1)]:
        base = [t(f(m * d + off)), t(f(m * d + off, sc=0.4))]
        args = [x[off:].view(m, d) for x in base] + [
            t(np.round(rng.random(m) * 4).astype(np.float32))]
        cases.append(("pres_predict", args, dict(clip=1.0),
                      f"M={m} D={d} offset={off}"))
    # neighbor_attn: M = 1 with K = 1, all-invalid rows (with K = 1 too),
    # ragged M, the CONFIG and PRODUCTION head widths, the K and E limits
    for m, kk, e, bad in [(1, 1, 8, 0), (5, 1, 16, 2), (9, 3, 12, 2),
                          (37, 16, 64, 3), (21, 10, 50, 1), (13, 10, 100, 0),
                          (33, 16, 128, 4), (3, 128, 256, 1)]:
        valid = rng.random((m, kk)) < 0.7
        valid[:bad] = False
        args = [t(f(m, e)), t(f(m, kk, e)), t(f(m, kk, e)), t(valid)]
        cases.append(("neighbor_attn", args, {},
                      f"M={m} K={kk} E={e} invalid_rows={bad}"))
    # pres_filter: M = 1, D % 4 != 0 and a misaligned start (the scalar
    # loop), counts of 0, scale * delta_mean past both clip bounds and
    # exactly on them, both delta modes
    modes = ("transition", "innovation")
    for m, d, off in [(1, 8, 0), (1, 7, 0), (37, 12, 0), (50, 7, 0),
                      (64, 16, 1), (1000, 100, 0)]:
        base = [t(f(m * d + off, sc=sc)) for sc in (0.5, 0.5, 2.0)]
        s_prev, s_meas, dmean = [x[off:].view(m, d) for x in base]
        dt = np.round(rng.random(m) * 4).astype(np.float32)
        dt[:2] = 2.0
        dmean[0, :2] = torch.tensor([0.5, -0.5])
        for mode in modes:
            cases.append(("pres_filter",
                          [s_prev, s_meas, dmean, t(dt), t(np.float32(0.37))],
                          dict(clip=1.0, delta_mode=mode),
                          f"M={m} D={d} offset={off} {mode}"))
    # memory_update (dense): M = 1, M = 129 (a ragged last block), Din != D,
    # the CONFIG and PRODUCTION widths, M at the 64-row tile + 1, widths
    # off the 16-byte copies, both delta modes
    for m, d, din in [(1, 8, 8), (129, 16, 16), (37, 20, 36), (1000, 100, 100),
                      (2000, 128, 128), (65, 128, 128), (45, 21, 37)]:
        args = [t(f(m, din)), t(f(m, d, sc=0.5)),
                t(f(din, 3 * d, sc=din ** -0.5)), t(f(d, 3 * d, sc=d ** -0.5)),
                t(f(3 * d, sc=0.1)), t(f(m, d, sc=0.3)),
                t(np.round(rng.random(m) * 3).astype(np.float32)),
                t(np.float32(0.37))]
        for mode in modes:
            cases.append(("memory_update", args,
                          dict(clip=1.0, delta_mode=mode),
                          f"M={m} D={d} Din={din} {mode}"))
    # flash_attn: S = 1, ragged S and T (not multiples of the 64-row
    # tiles), T != S both ways, windows (a window that leaves late rows
    # with no valid key when T < S: the mean of v), n_rep 1 / 2 / 3 / 4,
    # D 16 to 256 (80 and 96: multiples of 16, not of the wgmma route's
    # 64-column panels; 20: not a multiple of 8, padded for TMA), S = 8,192
    # causal, non-causal, fp32 (the FMA route) and bf16 (the wgmma route)
    for g, gkv, s_, t_, d, causal, window in [
            (1, 1, 1, 1, 64, True, None), (4, 2, 1, 37, 128, False, None),
            (2, 2, 100, 100, 64, True, None), (8, 2, 130, 130, 128, True, 50),
            (4, 1, 64, 200, 64, True, None), (4, 4, 200, 64, 40, True, None),
            (2, 1, 200, 50, 64, True, 10), (6, 3, 257, 257, 256, False, 70),
            (32, 16, 300, 300, 128, True, None),
            (3, 3, 129, 65, 16, False, None),
            (4, 2, 190, 190, 96, True, None), (2, 2, 100, 77, 80, False, 30),
            (6, 2, 150, 150, 128, True, None), (3, 1, 70, 70, 20, True, None),
            (4, 2, 8192, 8192, 128, True, None)]:
        for dt in (torch.float32, torch.bfloat16):
            args = [t(f(g, s_, d, sc=0.5)).to(dt),
                    t(f(gkv, t_, d, sc=0.5)).to(dt),
                    t(f(gkv, t_, d)).to(dt)]
            cases.append(("flash_attn", args,
                          dict(causal=causal, window=window),
                          f"G={g} Gkv={gkv} S={s_} T={t_} D={d} "
                          f"causal={causal} window={window} "
                          f"{str(dt).replace('torch.', '')}"))
    # ssd_chunk: L = 1, ragged L (not a multiple of the kernel's 32-row
    # tiles), L = 64 and 65 (two tiles exactly, and one row more), the xLSTM
    # widths N = 256, P = 257 at G = 8 and G = 1 (and its reduced N = 64,
    # P = 65), a large negative lcum (exp underflows to 0), P above 256 (a
    # third slab), N = 33 (not a multiple of 8), P = 8 (one column tile),
    # P = 264 (33 full tiles), and G = 3 with L P (and N P) odd, so the
    # later groups' v (and h0) start off a 16-byte boundary
    for g, ll, n, p, lsc in [(1, 1, 8, 9, 0.05), (3, 100, 16, 17, 0.05),
                             (8, 256, 256, 257, 0.05), (2, 300, 64, 65, 0.05),
                             (2, 256, 256, 257, 4.0), (1, 40, 33, 400, 0.5),
                             (2, 64, 64, 8, 0.05), (1, 65, 40, 264, 0.05),
                             (1, 256, 256, 257, 0.05), (3, 3, 33, 9, 0.05),
                             (3, 51, 64, 257, 0.05)]:
        lcum = np.cumsum(-np.abs(f(g, ll, sc=lsc)), -1).astype(np.float32)
        args = [t(f(g, ll, n, sc=0.1)), t(f(g, ll, n, sc=0.1)),
                t(f(g, ll, p, sc=0.5)), t(lcum), t(f(g, n, p, sc=0.5))]
        cases.append(("ssd_chunk", args, {},
                      f"G={g} L={ll} N={n} P={p} min_lcum="
                      f"{float(lcum.min()):.1f}"))
    return cases


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


class Capture:
    """Keeps a copy of the largest inputs each kernel of `names` (None:
    all) received while it is entered, the latest among equals, or with
    `latest=False` the first (a timed run then copies only when a larger
    input arrives); the launch goes through unchanged."""

    def __init__(self, names=None, latest=True):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = dict(ops.REGISTRY)
        self.names = set(self.saved if names is None else names)
        self.latest = latest
        self.best = {}

    @staticmethod
    def size(name, args):
        if name == "memory_update_table":
            return args[2].shape[0]
        if name == "gru_cell":
            return args[0].shape[0]
        if name == "link_score":
            return args[0].shape[0] * args[1].shape[0]
        if name == "pres_predict":
            return args[0].numel()
        if name == "neighbor_attn":
            return args[1].numel()
        if name == "pres_filter":
            return args[0].numel()
        if name == "memory_update":
            return args[0].shape[0]
        if name in ZOO_KERNELS:
            return args[0].numel()
        return args[0].shape[0] * args[2].shape[1]

    def __enter__(self):
        def wrap(name, fn):
            def run(*args, **kw):
                s = self.size(name, args)
                top = self.best.get(name, (-1,))[0]
                if s > top or (self.latest and s == top):
                    self.best[name] = (s, [a.clone() for a in args], dict(kw))
                return fn(*args, **kw)
            return run
        for name, spec in self.saved.items():
            if name in self.names:
                self.ops.REGISTRY[name] = dataclasses.replace(
                    spec, cuda=wrap(name, spec.cuda))
        return self

    def __exit__(self, *exc):
        self.ops.REGISTRY.update(self.saved)


def _compare_states(a, b, label):
    """Rings, times and counts exact; table, tracker sums and mailbox
    messages to 1e-4 (the trackers are index_add_ sums whose CUDA atomics
    order varies). The dump rows (last row of rings, trackers and
    mailbox) are not state."""
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
    if "mailbox" in a:
        for key in ("t", "ptr"):
            require(torch.equal(a["mailbox"][key][:-1], b["mailbox"][key][:-1]),
                    f"{label}: mailbox {key} differ")
        x, y = a["mailbox"]["msg"][:-1], b["mailbox"]["msg"][:-1]
        err = float((x - y).abs().max())
        require(err <= 1e-4 * max(1.0, float(y.abs().max())),
                f"{label}: mailbox messages differ by {err:.3g}")
        errs["mailbox"] = err
    for key, x, y, tol in [
            ("memory", a["memory"].mem, b["memory"].mem, 1e-4),
            ("xi", pa.xi, pb.xi, 1e-4), ("psi", pa.psi, pb.psi, 1e-4)]:
        err = float((x - y).abs().max())
        scale = max(1.0, float(y.abs().max()))
        require(err <= tol * scale, f"{label}: {key} differ by {err:.3g}")
        errs[key] = err
    return errs


def _report(label, rep, counts, engine):
    import torch
    log(f"[{label}] events={rep.n_events} ticks={rep.n_ticks} "
        f"events/s={rep.events_per_sec:.1f} "
        f"ingest p50={rep.ingest_p50_ms:.3f}ms p99={rep.ingest_p99_ms:.3f}ms "
        f"query p50={rep.query_p50_ms:.3f}ms p99={rep.query_p99_ms:.3f}ms "
        f"online_AP={rep.online_ap:.4f} "
        f"post_warmup_traces={dict(rep.post_warmup_traces)}")
    st = engine.state
    mb = lambda *ts: sum(x.numel() * x.element_size() for x in ts) / 1e6
    box = (f" mailbox={mb(*st['mailbox'].values()):.1f}"
           if "mailbox" in st else "")
    log(f"[{label}] state MB: memory={mb(st['memory'].mem):.1f} "
        f"trackers={mb(st['pres'].xi, st['pres'].psi, st['pres'].n):.1f} "
        f"rings={mb(*st['neighbors'].values()):.1f}{box}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB allocated,"
        f" {torch.cuda.max_memory_reserved() / 1e6:.1f} MB reserved")


def check_captured(label, eng):
    """Every key the engine prepared, once; a CUDA graph for exactly the
    keys whose body `captured_bodies(cfg)` names (a capture that failed
    would have raised)."""
    from repro_torch.serve import captured_bodies
    kinds = captured_bodies(eng.cfg)
    graphs = sorted(k for k, slot in eng._slots.items()
                    if slot.graph is not None)
    log(f"[{label}] trace_counts {sorted(eng.trace_counts.items())}; "
        f"captured {graphs}")
    require(all(c == 1 for c in eng.trace_counts.values()),
            f"{label}: a key prepared twice: {dict(eng.trace_counts)}")
    require(all((slot.graph is not None) == (k[0] in kinds)
                for k, slot in eng._slots.items()),
            f"{label}: captured {graphs}, expected the {sorted(kinds)} keys")
    return graphs


def serve_phase(label, cfg, stream, dst_range, dev, *, rate, tick,
                max_events, query_batch, topk_src, k, oracle_replay,
                big_query, probe, expect=SERVE_KERNELS, profile=0):
    """The engine as users get it (a CUDA graph per bucket where
    `captured_bodies(cfg)` allows), warmed up, then the replay, a large
    query and top-k with the launch counters set to 0 just before and
    read just after; the same through a capture=False engine, held to it
    (AP within 1e-3, states within `_compare_states`' tolerances, the
    same launch counts); then the plain versions (kernels_mode="oracle")."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.serve import MicroBatcher, ServeEngine, replay

    def engine(mode, capture=True):
        c = dataclasses.replace(cfg, kernels_mode=mode)
        params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
        return ServeEngine(c, params, mdgnn.init_state(c, dev),
                           batcher=MicroBatcher(d_edge=stream.feat_dim),
                           item_range=dst_range, device=dev, capture=capture)

    kw = dict(rate=rate, tick=tick, query_batch=query_batch, seed=0,
              max_events=max_events, warmup=False)
    q_src, q_dst = stream.src[:big_query], stream.dst[:big_query]
    q_t = np.full(big_query, stream.t[max_events - 1], np.float32)
    ts = np.full(len(topk_src), stream.t[max_events - 1], np.float32)

    def drive(eng):
        """Warm-up (the captures), then the counted run: (report, counts,
        folds, scores, top-k values and ids, warm-up s, peak MB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        res0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup(query=True, topk_k=k)
        warm_s = time.perf_counter() - t0
        folds = [0]
        fold = eng._fold

        def counted(batch):
            folds[0] += 1
            return fold(batch)
        eng._fold = counted
        ops.reset_launch_counts()
        rep = replay(eng, stream, dst_range, **kw)
        scores = eng.query(q_src, q_dst, q_t)
        vals, ids = eng.recommend_topk(topk_src, ts, k)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        del eng._fold
        # the engine's own: peak allocated and reserved above the start
        # (its state was made before; earlier engines' pools stay out)
        peak = {"allocated": (torch.cuda.max_memory_allocated()
                              - alloc0) / 1e6,
                "reserved": (torch.cuda.max_memory_reserved() - res0) / 1e6}
        return rep, counts, folds[0], scores, vals, ids, warm_s, peak

    eng = engine("auto")
    rep, counts, folds, scores, vals, ids, warm_s, peak = drive(eng)
    _report(label, rep, counts, eng)
    graphs = check_captured(label, eng)
    summary = {"events": rep.n_events, "folds": folds,
               "events_per_s": rep.events_per_sec,
               "ingest_p50_ms": rep.ingest_p50_ms,
               "ingest_p99_ms": rep.ingest_p99_ms,
               "query_p50_ms": rep.query_p50_ms,
               "query_p99_ms": rep.query_p99_ms, "online_ap": rep.online_ap,
               "peak_mem_mb": peak["allocated"],
               "peak_reserved_mb": peak["reserved"], "warmup_s": warm_s,
               "captured": [list(g) for g in graphs],
               "post_warmup_traces": {" ".join(map(str, key)): c for key, c
                                      in rep.post_warmup_traces.items()}}
    require(not rep.post_warmup_traces,
            f"{label}: the replay prepared keys after warm-up: "
            f"{rep.post_warmup_traces}")
    check_launches(label, counts, expect)
    stage = memory_stage_kernel(cfg)
    require(counts[stage] == folds, f"{label}: {stage} launched "
            f"{counts[stage]} times in {folds} folds")
    require(np.isfinite(scores).all() and scores.shape == (big_query,),
            f"{label}: bad query scores")
    require(vals.shape == (len(topk_src), k) and np.isfinite(vals).all()
            and ((ids >= dst_range[0]) & (ids < dst_range[1])).all(),
            f"{label}: bad top-k output")
    require(0.0 <= rep.online_ap <= 1.0, f"{label}: AP out of range")

    # the same replay through the engine without graphs
    eager = engine("auto", capture=False)
    rep_e, counts_e, folds_e, scores_e, vals_e, _, warm_e, peak_e = \
        drive(eager)
    errs = _compare_states(eng.state, eager.state, f"{label} vs eager")
    e_err = max(float(np.abs(scores - scores_e).max()),
                float(np.abs(vals - vals_e).max()))
    summary["eager"] = {
        "events_per_s": rep_e.events_per_sec,
        "ingest_p50_ms": rep_e.ingest_p50_ms,
        "ingest_p99_ms": rep_e.ingest_p99_ms,
        "query_p50_ms": rep_e.query_p50_ms,
        "query_p99_ms": rep_e.query_p99_ms, "online_ap": rep_e.online_ap,
        "peak_mem_mb": peak_e["allocated"],
        "peak_reserved_mb": peak_e["reserved"], "warmup_s": warm_e,
        "state_diff": errs, "score_diff": e_err}
    log(f"[{label}] captured / eager: events/s {rep.events_per_sec:.1f} / "
        f"{rep_e.events_per_sec:.1f}, ingest p50 {rep.ingest_p50_ms:.3f} / "
        f"{rep_e.ingest_p50_ms:.3f} ms, p99 {rep.ingest_p99_ms:.3f} / "
        f"{rep_e.ingest_p99_ms:.3f} ms, query p50 {rep.query_p50_ms:.3f} / "
        f"{rep_e.query_p50_ms:.3f} ms, p99 {rep.query_p99_ms:.3f} / "
        f"{rep_e.query_p99_ms:.3f} ms, AP {rep.online_ap:.6f} / "
        f"{rep_e.online_ap:.6f}, post_warmup_traces "
        f"{dict(rep.post_warmup_traces)} / {dict(rep_e.post_warmup_traces)}, "
        f"peak MB above the start, allocated {peak['allocated']:.1f} / "
        f"{peak_e['allocated']:.1f}, reserved {peak['reserved']:.1f} / "
        f"{peak_e['reserved']:.1f}, warm-up {warm_s:.2f} / {warm_e:.2f} s; "
        f"max|state diff| {json.dumps(errs)}, max|score diff| {e_err:.3g}")
    require(abs(rep.online_ap - rep_e.online_ap) <= 1e-3,
            f"{label}: AP {rep.online_ap} captured vs {rep_e.online_ap} "
            f"eager")
    require(counts_e == counts and folds_e == folds,
            f"{label}: launches {counts} in {folds} folds captured, "
            f"{counts_e} in {folds_e} eager")

    plain = engine("oracle", capture=False)
    if oracle_replay:
        rep_o = replay(plain, stream, dst_range, **kw)
        errs = _compare_states(eng.state, plain.state, label)
        summary["vs_plain_state"] = errs
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
    summary.update(vs_plain_query=q_err, vs_plain_topk=k_err)
    require(q_err <= 1e-3 * max(1.0, float(np.abs(s_o).max())),
            f"{label}: query scores differ from the plain path by {q_err}")
    require(k_err <= 1e-3 * max(1.0, float(np.abs(v_o).max())),
            f"{label}: top-k scores differ from the plain path by {k_err}")

    # phase 10's inputs: one more fold, query and top-k on the eager
    # engine's final state (a graph replay calls no wrapper to capture
    # them from), made after the counters were read
    with Capture() as cap:
        hi = max_events + probe
        eager.ingest(stream.src[max_events:hi], stream.dst[max_events:hi],
                     stream.t[max_events:hi], stream.feat[max_events:hi])
        eager.query(q_src, q_dst, q_t)
        eager.recommend_topk(topk_src, ts, k)
        torch.cuda.synchronize()
    if profile:
        for tag, e in ((label, eng), (f"{label}-eager", eager)):
            DEFERRED_PROFILES.append(functools.partial(
                _profile, tag, e, stream, max_events + probe, profile,
                q_src[:64], q_dst[:64], q_t[:64]))
    return counts, cap.best, summary


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
    _report_profile(label, prof, wall_us, f"{ticks} x (query 64 pairs + "
                    f"fold {step} events)")


def _profile_prefill(label, model, params, tokens):
    """torch.profiler over one prefill of the zoo model."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _last_logits(model, params, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(label, prof, wall_us, "one bf16 prefill")


def _report_profile(label, prof, wall_us, what):
    """Device time by kernel and the device busy share of the window's
    wall time (the profiler's own host overhead is inside that wall
    time)."""
    import torch
    # device-side entries, without the engine's record_function ranges
    # (those span their kernels and the gaps between them)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("serve_")]
    busy_us = sum(e.self_device_time_total for e in events)
    PROFILES[label] = {"window": what, "wall_ms": wall_us / 1e3,
                       "busy_ms": busy_us / 1e3,
                       "busy_share": busy_us / wall_us,
                       "launches": sum(e.count for e in events)}
    log(f"[{label}] profile: {what}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[{label}] profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} x {e.key[:90]}")


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------


def _clone(params, opt_state, state, pstate=None):
    """Copies of a training carry that share no storage with it: (params,
    opt_state, state) and, on the pipelined schedule, the snapshot."""
    from repro_torch.models import mdgnn
    from repro_torch.train.pipeline import PipelineState
    from repro_torch.utils.tree import tree_map
    out = (tree_map(lambda t: t.detach().clone(), params),
           tree_map(lambda t: t.clone(), opt_state),
           mdgnn.clone_state(state))
    if pstate is None:
        return out
    return out + (PipelineState(pstate.read_mem.clone(),
                                pstate.read_last_update.clone(),
                                pstate.pending.clone(), pstate.tick),)


def _run_train(cfg, opt, start, batches, steps, negs, val, dst_range, timed):
    """pipeline.run_epoch (the lag-one loop at depth 0) over the first
    `steps` steps from clones of `start` = (params, opt_state, state), then
    loop.evaluate when `val` = (batches, negatives) is given. Returns
    (per-step losses, per-step device-synced seconds (timed runs),
    EpochResult, (val AP, val AUC) or None, final state, final params)."""
    import torch
    from repro_torch.train import loop, pipeline
    params, opt_state, state = _clone(*start)
    step = pipeline.make_train_step(cfg, opt)
    losses, secs = [], []

    def recorded(*a):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = step(*a)
        if timed:
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        losses.append(out[-1]["loss"])
        return out

    params, opt_state, state, res = pipeline.run_epoch(
        params, opt_state, state, batches[:steps + 1], cfg, recorded, None,
        dst_range, negatives=negs[:steps])
    ev = None
    if val is not None:
        _, vap, vauc = loop.evaluate(params, state, val[0], cfg,
                                     loop.make_eval_step(cfg), None,
                                     dst_range, negatives=val[1])
        ev = (vap, vauc)
    return [float(x) for x in losses], secs, res, ev, state, params


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms: index_add_ (the mean aggregator,
    the PRES statistics) and the gathers' backward sum in index order, not
    in the order atomics land, so a run gives the same numbers every time.
    Any op without a deterministic version raises. cuBLAS is deterministic
    on one stream, which is all this script uses; torch's alert for it
    (it asks for CUBLAS_WORKSPACE_CONFIG, read once per process, which
    slowed the timed runs' host-bound steps on the H100) is silenced."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "error", message=".*does not have a deterministic")
            warnings.filterwarnings("ignore", message=".*it uses CuBLAS")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def _carry(cfg, start):
    """Clones of `start`, with a fresh snapshot on the pipelined schedule."""
    from repro_torch.train.pipeline import PipelineState
    carry = _clone(*start)
    if cfg.pipeline_depth:
        carry += (PipelineState.init(carry[2]["memory"]),)
    return carry


def _profile_train(label, cfg, opt, start, batches, negs, n):
    """torch.profiler over train steps 2..n+1 from clones of `start` (the
    first step, unprofiled, warms the allocator)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import pipeline
    step = pipeline.make_train_step(cfg, opt)
    carry = step(*_carry(cfg, start), batches[0], batches[1], negs[0])[:-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n + 1):
            carry = step(*carry, batches[i], batches[i + 1], negs[i])[:-1]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(label, prof, wall_us, f"{n} train steps")


def _step_vs_plain(cfg, opt, start, batches, negs, steps, other):
    """Every step of `cfg`'s route against the step of `other` (the plain
    versions of the kernels, or for the plain route the kernel route)
    taken from the SAME parameters, optimizer state and model state (and,
    on the pipelined schedule, snapshot), so no difference is carried from
    one step to the next. Returns the worst relative difference of each
    quantity over the steps: the loss, the logits, the memory table after
    the step (and the snapshot), and the optimizer's first moments (after
    one step 0.1 x the gradient) as one vector and leaf by leaf, with the
    worst leaf's name."""
    from repro_torch.train import pipeline
    from repro_torch.utils.tree import tree_leaves
    carry = _carry(cfg, start)
    k_step = pipeline.make_train_step(cfg, opt)
    p_step = pipeline.make_train_step(other, opt)
    amax = lambda t: float(t.abs().max())
    rel = lambda a, b, floor: amax(a - b) / max(floor, amax(b))
    names = _leaf_names(start[0])
    worst = {"loss": 0.0, "logits": 0.0, "memory": 0.0, "moments": 0.0,
             "moments_leaf": 0.0, "worst_leaf": None}
    for i in range(steps):
        p_out = p_step(*_clone(*carry), batches[i], batches[i + 1], negs[i])
        k_out = k_step(*carry, batches[i], batches[i + 1], negs[i])
        carry = k_out[:-1]
        k_m, p_m = k_out[-1], p_out[-1]
        k_mu = tree_leaves(k_out[1]["mu"])
        p_mu = tree_leaves(p_out[1]["mu"])
        # (the first pipelined step's moments are all 0: the snapshot and
        # the rings are empty and the coherence term has no gradient at a
        # zero memory)
        top = max(max(amax(b) for b in p_mu), 1e-30)
        memory = rel(k_out[2]["memory"].mem, p_out[2]["memory"].mem, 1.0)
        if cfg.pipeline_depth:
            memory = max(memory, rel(k_out[3].read_mem, p_out[3].read_mem,
                                     1.0))
        got = {"loss": rel(k_m["loss"], p_m["loss"], 0.0),
               "logits": max(rel(k_m[k], p_m[k], 1.0)
                             for k in ("logit_p", "logit_n")),
               "memory": memory,
               "moments": max(amax(a - b) for a, b in zip(k_mu, p_mu)) / top}
        for k, v in got.items():
            worst[k] = max(worst[k], v)
        for name, a, b in zip(names, k_mu, p_mu):
            if amax(a) or amax(b):
                r = rel(a, b, 1e-30)
                if r > worst["moments_leaf"]:
                    worst["moments_leaf"], worst["worst_leaf"] = r, name
    return worst


def _leaf_names(tree, path=""):
    """'/'-joined key paths of the leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{path}/{k}")]
    return [path]


def train_phase(label, cfg, train_s, val_s, dst_range, dev, *, batch_size,
                n_batches, expect, oracle_steps=None, capture=(),
                profile=0, against=None, noise_floor=False):
    """Train one epoch of `n_batches` temporal batches (then evaluate on
    `val_s` unless it is None) through the kernels, counting launches;
    then the same from the same start and negatives through the plain
    versions (or through `against`, the config of another route), for all
    steps or the first `oracle_steps`, and compare. With `noise_floor`
    the free-running first losses and AP gaps are held to their limits
    plus the plain route's own spread when its table is perturbed at
    the size of a kernel's rounding (`_nudged_gaps`). The
    memory stage's kernel (`memory_stage_kernel`) must launch exactly once
    a train and an evaluation step, and on the pipelined schedule
    (cfg.pipeline_depth >= 1) `pres_predict` once a train step. Returns
    (launch counts, the largest inputs of the kernels in `capture`,
    summary)."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw

    batches = train_s.temporal_batches(batch_size, dev)[:n_batches]
    steps = len(batches) - 1
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    val = None
    if val_s is not None:
        vb = val_s.temporal_batches(batch_size, dev)
        val = (vb, [sample_negatives(gen, b, *dst_range) for b in vb[1:]])
    opt = adamw(1e-3)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    start = (params, opt.init(params), mdgnn.init_state(cfg, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # gru_cell's inputs are copied when a larger one arrives, in practice
    # at the first step only, which events/s and the median step leave out
    with Capture(names=[n for n in capture if n == "gru_cell"],
                 latest=False) as cap:
        losses, secs, res, ev, state, params_f = _run_train(
            cfg, opt, start, batches, steps, negs, val, dst_range, True)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    inputs = dict(cap.best)
    inputs.update(_probe(cfg, capture, params_f, state, batches[-1],
                         negs[-1]))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check_launches(label, counts, expect)
    stage = memory_stage_kernel(cfg)
    calls = steps + (len(val[0]) - 1 if val is not None else 0)
    require(stage is None or counts[stage] == calls,
            f"{label}: {stage} launched {counts.get(stage)} times in {calls} "
            f"train and evaluation steps")
    if cfg.pipeline_depth:
        require(counts["pres_predict"] == steps,
                f"{label}: pres_predict launched {counts['pres_predict']} "
                f"times in {steps} pipelined steps")
    require(np.isfinite(losses).all() and len(losses) == steps,
            f"{label}: bad losses {losses}")
    require(bool(torch.isfinite(state["memory"].mem).all()),
            f"{label}: memory table not finite")
    require(0.0 <= res.ap <= 1.0, f"{label}: train AP out of range")
    # the first step pays one-time costs (cuBLAS handles, autograd's first
    # backward, the allocator): reported apart, and left out of events/s
    summary = {"steps": steps, "batch": batch_size,
               "first_step_ms": secs[0] * 1e3,
               "step_ms_median": float(np.median(secs[1:])) * 1e3,
               "train_events_per_s": (steps - 1) * batch_size
               / sum(secs[1:]), "loss": res.loss,
               "train_ap": res.ap, "peak_mem_mb": peak_mb,
               "first_losses": losses[:3]}
    if ev is not None:
        summary.update(val_ap=ev[0], val_auc=ev[1])
    log(f"[{label}] {json.dumps(summary)}")

    # free-running: the same epoch from the same start and negatives
    # through the kernels again and through the plain versions. Their
    # rounding differences (1e-7) grow from step to step through training
    # (AdamW turns a near-zero gradient's rounding into a whole update), so
    # past the first steps this bounds the outcome, not the arithmetic.
    # Both runs use deterministic algorithms: with sums in atomic order the
    # gap itself varied from run to run (val AP 0.004-0.022 on the H100)
    o_cfg = against or dataclasses.replace(cfg, kernels_mode="oracle")
    n_free = oracle_steps or steps
    free_val = val if oracle_steps is None else None
    with _deterministic():
        k_losses, _, k_res, k_ev, k_state, _ = _run_train(
            cfg, opt, start, batches, n_free, negs, free_val, dst_range,
            False)
        o_losses, _, o_res, o_ev, o_state, _ = _run_train(
            o_cfg, opt, start, batches, n_free, negs, free_val, dst_range,
            False)
        # teacher-forced: every step from the same state, held tightly
        per_step = (_step_vs_plain(cfg, opt, start, batches, negs, steps,
                                   o_cfg)
                    if oracle_steps is None else None)
        floor = (_nudged_gaps(o_cfg, opt, start, batches, n_free, negs,
                              free_val, dst_range, o_losses, o_res, o_ev)
                 if noise_floor else {})
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(k_losses, o_losses)]
    diff = {"loss_rel_by_step": rel}
    if oracle_steps is None:
        diff.update(train_ap=abs(k_res.ap - o_res.ap),
                    memory_table=float((k_state["memory"].mem
                                        - o_state["memory"].mem).abs().max()))
        if k_ev is not None:
            diff["val_ap"] = abs(k_ev[0] - o_ev[0])
        diff["per_step"] = per_step
    if floor:
        diff["noise_floor"] = floor
    other = "the kernel route" if against else "the plain path"
    log(f"[{label}] vs {other}: {json.dumps(diff)}")
    require(max(rel[:3]) <= 1e-4 + floor.get("first_losses", 0.0),
            f"{label}: first losses {k_losses[:3]} vs {other} "
            f"{o_losses[:3]}")
    for k in ("train_ap", "val_ap"):
        lim = AP_LIMIT + floor.get(k, 0.0)
        require(diff.get(k, 0.0) <= lim, f"{label}: {k} differs from "
                f"{other}'s by {diff.get(k)} > {lim}")
    for k, lim in STEP_TOL.items():
        got = diff.get("per_step", {}).get(k, 0.0)
        require(got <= lim, f"{label}: a step's {k} differs from {other}'s "
                f"step by {got:.3g} (relative) > {lim}")
    summary["vs_plain"] = diff
    if profile:
        DEFERRED_PROFILES.append(functools.partial(
            _profile_train, label, cfg, opt, start, batches, negs,
            min(profile, steps - 1)))
    return counts, inputs, summary


@contextlib.contextmanager
def _nudge_table(eps):
    """Every memory stage (train and evaluation) adds eps * max(1, |x|) *
    r to each entry x of the table after it writes it, r a fixed pattern
    of random signs (seed 0): a perturbation of the form, and at eps =
    1e-6 about the size, of a kernel's difference from its plain version
    (`TOL`, and the per-step memory differences the train phases log)."""
    import torch
    from repro_torch.train import loop
    stage = loop.memory_and_pres
    signs = {}

    def nudged(*a, **kw):
        out = stage(*a, **kw)
        with torch.no_grad():
            mem = out[0].mem
            if "r" not in signs:
                gen = torch.Generator(mem.device).manual_seed(0)
                signs["r"] = torch.randint(
                    0, 2, mem.shape, generator=gen, device=mem.device,
                    dtype=mem.dtype) * 2 - 1
            mem.add_(eps * torch.clamp(mem.abs(), min=1.0) * signs["r"])
        return out

    loop.memory_and_pres = nudged
    try:
        yield
    finally:
        loop.memory_and_pres = stage


def _nudged_gaps(cfg, opt, start, batches, steps, negs, val, dst_range,
                 losses, res, ev):
    """The plain route's own free-running spread: the largest relative gap
    of its first 3 losses, and its train and val AP gaps, to `losses`,
    `res` and `ev` (its unperturbed run) when every memory stage perturbs
    the table by +-1e-7 and +-1e-6 of its scale (`_nudge_table`); the
    largest of the four runs for each. A model that this spread already
    moves by more than the free-running limits (JODIE's raw-time
    projection, ROADMAP R7) cannot be held to those limits alone."""
    gaps = {"first_losses": 0.0, "train_ap": 0.0, "val_ap": 0.0}
    for eps in (1e-7, -1e-7, 1e-6, -1e-6):
        with _nudge_table(eps):
            n_losses, _, n_res, n_ev, _, _ = _run_train(
                cfg, opt, start, batches, steps, negs, val, dst_range, False)
        gaps["first_losses"] = max([gaps["first_losses"]] + [
            abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(n_losses[:3], losses[:3])])
        gaps["train_ap"] = max(gaps["train_ap"], abs(n_res.ap - res.ap))
        if ev is not None:
            gaps["val_ap"] = max(gaps["val_ap"], abs(n_ev[0] - ev[0]))
    return gaps


def _probe(cfg, names, params, state, batch, neg):
    """Inputs of `names` other than gru_cell from one more call of the
    path on the trained state, made after the counters were read: the
    embedding of the last step's endpoints (neighbor_attn; at the first
    step the rings are still empty), the staleness fill with one batch in
    flight (pres_predict), and the memory stage on a copy of the state
    (pres_filter; for memory_update, the rows `memory_update_table` gathers
    and the rest of its inputs: the dense op on the same occurrences)."""
    import torch
    from repro_torch.kernels import autodiff
    from repro_torch.models import mdgnn
    from repro_torch.train import loop, pipeline
    names = [n for n in names if n != "gru_cell"]
    if not names:
        return {}
    wrap = set(names)
    if "memory_update" in names:
        wrap.add("memory_update_table")
    with torch.no_grad(), Capture(names=wrap) as cap:
        if "pres_predict" in names:
            ps = pipeline.PipelineState.init(state["memory"])
            nodes = torch.cat([batch.src, batch.dst])
            ps.pending.index_add_(0, nodes, torch.cat(
                [batch.mask, batch.mask]).float())
            pipeline.stale_read_table(cfg, state["pres"], ps,
                                      state["memory"].last_update)
        if "neighbor_attn" in names:
            loop.endpoint_logits(params, cfg, state, batch, neg)
        if {"pres_filter", "memory_update"} & wrap:
            loop.memory_and_pres(params, cfg, mdgnn.clone_state(state),
                                 batch)
        torch.cuda.synchronize()
    best = dict(cap.best)
    if "memory_update" in names:
        _, a, kw = best.pop("memory_update_table")
        table, _, x, gidx, _, _, w, u, b, dm, scale, gamma = a
        best["memory_update"] = (x.shape[0], [
            x, autodiff.gather_rows(table, gidx), w, u, b, dm, scale, gamma],
            kw)
    return best


def cli_phase(label, argv, expect):
    """`python -m repro_torch.launch.train` with `argv` on the card (its
    default device), one epoch; its epoch line is printed by the CLI."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    ops.reset_launch_counts()
    hist = train_cli.main(argv)
    check_launches(label, ops.launch_counts(), expect)
    h = hist[-1]
    require(len(hist) == 1 and np.isfinite(h["loss"])
            and 0.0 <= h["val_ap"] <= 1.0, f"{label}: bad history {hist}")
    return h


def parity_phase(label, cfg, stream, dst_range, dev):
    """serve/parity.py's gate on the card: the captured engine against
    `loop.make_eval_step` in lock step over `stream` (buckets 16 and 64),
    within the JAX gate's 1e-5, each key prepared once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.serve import MicroBatcher, check_offline_parity
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    state = mdgnn.init_state(cfg, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    max_diff, n_scored, eng = check_offline_parity(
        cfg, params, state, stream, dst_range, device=dev,
        batcher=MicroBatcher(buckets=(16, 64), d_edge=cfg.d_edge))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"[{label}] {len(stream)} events, {n_scored} pairs scored: "
        f"max|engine - eval_step| = {max_diff:.3g} ({secs:.1f}s)")
    graphs = check_captured(label, eng)
    check_launches(label, counts, ("memory_update_table", "embed_attn"))
    require(n_scored > 1000, f"{label}: only {n_scored} pairs scored")
    require(max_diff < 1e-5, f"{label}: serve/evaluate drift {max_diff}")
    require(("ingest", 64) in graphs, f"{label}: the fold was not captured")
    return {"max_diff": max_diff, "n_scored": n_scored, "seconds": secs,
            "trace_counts": {" ".join(map(str, key)): c for key, c
                             in eng.trace_counts.items()}}


def cli_ckpt_phase(label, cfg, stream, dst_range, dev, expect):
    """The train CLI with --checkpoint (one epoch on the card), then the
    serve CLI with --checkpoint on the file; then an engine restored by
    `ServeEngine.from_checkpoint` against one built from the trainer's own
    params and state (kept when it saved): the same query scores within
    TOL."""
    import tempfile
    import numpy as np
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import mdgnn
    from repro_torch.serve import ServeEngine
    kept = {}
    bundle = bridge.mdgnn_bundle

    def keep(params, state):
        kept.update(params=params, state=mdgnn.clone_state(state))
        return bundle(params, state)
    model = ["--dataset", "wiki-small", "--model", "tgn", "--pres",
             "--use-kernels"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "wiki.ckpt")
        bridge.mdgnn_bundle = keep
        try:
            ops.reset_launch_counts()
            hist = train_cli.main(model + ["--epochs", "1", "--checkpoint",
                                           path])
        finally:
            bridge.mdgnn_bundle = bundle
        check_launches(f"{label}-train", ops.launch_counts(), expect)
        require(pathlib.Path(path).is_file() and "params" in kept,
                f"{label}: no checkpoint written")
        ops.reset_launch_counts()
        rep = serve_cli.main(model + ["--checkpoint", path, "--max-events",
                                      "2000", "--topk", "5"])
        check_launches(f"{label}-serve", ops.launch_counts(), SERVE_KERNELS)
        require(not rep.post_warmup_traces and 0.0 <= rep.online_ap <= 1.0,
                f"{label}: serve CLI report {rep}")
        restored = ServeEngine.from_checkpoint(path, cfg, device=dev,
                                               item_range=dst_range)
    live = ServeEngine(cfg, kept["params"], kept["state"], device=dev,
                       item_range=dst_range)
    q = slice(0, 512)
    t = np.full(512, stream.t[-1], np.float32)
    got = restored.query(stream.src[q], stream.dst[q], t)
    want = live.query(stream.src[q], stream.dst[q], t)
    err = float(np.abs(got - want).max())
    log(f"[{label}] restored vs in-memory engine: max|query diff| "
        f"{err:.3g}; serve CLI AP {rep.online_ap:.4f}")
    require(np.isfinite(got).all()
            and err <= TOL["embed_attn"] * max(1.0, float(np.abs(want).max())),
            f"{label}: restored scores differ by {err}")
    return {"train": hist[-1], "serve_ap": rep.online_ap,
            "restored_vs_live": err}


def cli_csv_phase(label, expect):
    """The train CLI with --csv on the checked-in mini csv, one epoch on
    the card; its validation split is one event, so val AP is nan."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    ops.reset_launch_counts()
    hist = train_cli.main(["--csv", str(ROOT / "tests" / "data" /
                                        "mini_jodie.csv"),
                           "--model", "tgn", "--pres", "--use-kernels",
                           "--batch-size", "2", "--epochs", "1"])
    check_launches(label, ops.launch_counts(), expect)
    require(len(hist) == 1 and np.isfinite(hist[0]["loss"]),
            f"{label}: bad history {hist}")
    return hist[0]


def op_phase(label, name, inputs):
    """The registry op `name` on the inputs a phase captured, as a train
    step runs it: the kernel forward under autograd, then the backward
    through the plain version for random cotangents. For an op with no
    call site in the model (memory_update, as in the JAX package, whose
    kernel benchmark drives the registry op). Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    _, a, kw = inputs[name]
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in a]
    gen = torch.Generator(a[0].device).manual_seed(0)
    ops.reset_launch_counts()
    outs = getattr(ops, name)(*leaves, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [
        torch.randn(o.shape, generator=gen, device=o.device) for o in outs])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_launches(label, counts, (name,))
    require(counts[name] == 1 and all(
        bool(torch.isfinite(x.grad).all()) for x in leaves
        if x.grad is not None), f"{label}: bad launch count or gradient")
    return counts


# ---------------------------------------------------------------------------
# phases zoo-qwen3 / zoo-xlstm / cli-zoo: the model zoo at full width
# ---------------------------------------------------------------------------


def check_routes(label, what, expect, kernel):
    """flash_attn's launches by route (fma: fp32 inputs, wgmma: bf16)."""
    if kernel != "flash_attn":
        return
    from repro_torch.kernels import flash_attn as fa
    log(f"[{label}] {what} flash_attn launches by route "
        f"{json.dumps(fa.launches_by_route)}")
    require(fa.launches_by_route == expect, f"{label}: {what} flash_attn "
            f"routes {fa.launches_by_route}, expected {expect}")


def _last_logits(model, params, tokens):
    """forward(...)[:, -1] in float32 (a copy: the (B, S, V) logits go)."""
    return model.forward(params, {"tokens": tokens})[:, -1].float().clone()


def zoo_phase(label, dev, seed, decode_steps=16, profile=0):
    """Prefill at full width: the published config with random weights
    from `seed`, B x S random tokens. (1) float32 through the kernel route,
    counted: the phase's kernel exactly once a layer (flash_attn) or a
    chunk and mLSTM layer (ssd_chunk), no other kernel; the last
    position's logits against the plain route (kernels_mode="oracle")
    within ZOO_TOL. (2) the published bfloat16 timed: median of 3
    device-synced prefills (after one warm-up that captures the kernel's
    inputs for its row), tokens/s and peak device memory, the same
    launches a prefill. (3) `decode_steps` greedy decode steps from the
    prefill's next token against a cache of S slots: ms a step, and no
    kernel launched. Returns (launch counts of (1), captured inputs,
    summary)."""
    import numpy as np
    import torch
    from repro_torch.archs.api import get_model
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves
    arch, kernel, b, s, per_prefill = ZOO[label]
    cfg = get_config(arch)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = get_model(cfg32)
    gen = torch.Generator(dev).manual_seed(seed)
    params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    summary = {"arch": arch, "batch": b, "seq": s, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "params": n_params}
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = _last_logits(model, params, tokens)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_launches(label, counts, (kernel,))
        require(counts[kernel] == per_prefill, f"{label}: {kernel} launched "
                f"{counts[kernel]} times in one prefill, expected "
                f"{per_prefill}")
        check_routes(label, "fp32", {"fma": per_prefill, "wgmma": 0},
                     kernel)
        want = _last_logits(get_model(dataclasses.replace(
            cfg32, kernels_mode="oracle")), params, tokens)
        require(tuple(got.shape) == (b, cfg.vocab)
                and bool(torch.isfinite(got).all()),
                f"{label}: bad prefill logits {tuple(got.shape)}")
        err = float((got - want).abs().max())
        lim = ZOO_TOL * max(1.0, float(want.abs().max()))
        log(f"[{label}] fp32 prefill vs plain route: max|diff| {err:.3g} "
            f"(limit {lim:.3g}); argmax agree "
            f"{bool((got.argmax(-1) == want.argmax(-1)).all())}")
        require(err <= lim, f"{label}: prefill logits differ from the plain "
                f"route by {err:.3g} > {lim:.3g}")
        summary.update(fp32_vs_plain=err, fp32_limit=lim)
        del got, want

        bf = get_model(cfg)                     # the published bfloat16
        # ssd_chunk's row takes the prefill's last launch, whose carry-in
        # h0 is nonzero; flash_attn's launches all take alike inputs
        with Capture(names=[kernel], latest=kernel == "ssd_chunk") as cap:
            _last_logits(bf, params, tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = _last_logits(bf, params, tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts_bf = ops.launch_counts()
        check_launches(label, counts_bf, (kernel,))
        require(counts_bf[kernel] == 3 * per_prefill,
                f"{label}: bf16 prefills launched {kernel} "
                f"{counts_bf[kernel]} times")
        check_routes(label, "bf16 (3 prefills)",
                     {"fma": 0, "wgmma": 3 * per_prefill}, kernel)
        require(bool(torch.isfinite(last).all()),
                f"{label}: bf16 prefill logits not finite")
        med = float(np.median(secs))
        summary.update(prefill_s=secs, prefill_s_median=med,
                       prefill_tokens_per_s=b * s / med,
                       prefill_peak_mem_mb=torch.cuda.max_memory_allocated()
                       / 1e6)

        state = bf.init_decode_state(b, s, dev)
        tok = last.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_ms = []
        for pos in range(decode_steps):
            t0 = time.perf_counter()
            logits, state = bf.decode_step(params, state, tok, pos)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts_dec = ops.launch_counts()
        require(not any(counts_dec.values()),
                f"{label}: decode launched a kernel: {counts_dec}")
        require(tuple(logits.shape) == (b, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{label}: bad decode logits")
        summary.update(decode_steps=decode_steps, decode_cache=s,
                       decode_ms_first=step_ms[0],
                       decode_ms_median=float(np.median(step_ms[1:])),
                       decode_tokens_per_s=b * 1e3
                       / float(np.median(step_ms[1:])))
        log(f"[{label}] {json.dumps(summary)}")
        if profile:
            DEFERRED_PROFILES.append(functools.partial(
                _profile_prefill, label, bf, params, tokens))
    del params, state
    torch.cuda.empty_cache()
    return counts, cap.best, summary


def cli_zoo_phase(label, arch, steps):
    """`python -m repro_torch.launch.serve --zoo <arch>` on the card (its
    default device): greedy decode of the reduced config, which launches
    no kernel (the zoo's kernels run in the prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    toks = serve_cli.main(["--zoo", arch, "--steps", str(steps)])
    counts = ops.launch_counts()
    require(not any(counts.values()),
            f"{label}: the zoo decode CLI launched a kernel: {counts}")
    require(tuple(toks.shape) == (2, steps), f"{label}: bad tokens")
    return {"tokens": toks[0].tolist()}


def library_gru_cell(args):
    """torch.gru_cell computing the port's cell on the same inputs, as the
    kernel's yardstick (never on the path). PyTorch's z weights h, the
    port's weights n: with the z blocks of W, U and b negated,
    sigmoid(-a) = 1 - sigmoid(a) turns one into the other. The hidden bias
    is zero (the port has none)."""
    import torch
    x, h, w, u, b = args
    d = h.shape[1]
    flip = torch.ones(3 * d, device=x.device)
    flip[d:2 * d] = -1.0
    w_ih = (w * flip).t().contiguous()
    w_hh = (u * flip).t().contiguous()
    b_ih = (b * flip).contiguous()
    b_hh = torch.zeros_like(b_ih)
    return lambda: torch.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh), args


def library_neighbor_attn(args):
    """scaled_dot_product_attention with a boolean mask computing the
    kernel's function, as its yardstick (never on the path): one query a
    row, batch M, one head. SDPA gives NaN for a row with no valid slot,
    so rows with none get slot 0 valid; the yardstick and the plain
    version it is checked against both take those inputs."""
    import torch
    import torch.nn.functional as F
    q, k, v, valid = args
    valid = valid.clone()
    valid[~valid.any(1), 0] = True
    q4, k4, v4 = q[:, None, None], k[:, None], v[:, None]
    mask = valid[:, None, None]
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask)[:, 0, 0],
            [q, k, v, valid])


def library_flash_attn(args):
    """scaled_dot_product_attention (causal, GQA) on the same tensors laid
    out as (1, heads, S, D), as the kernel's yardstick (never on the
    path). Only the path's inputs reach it: causal, no window, S = T."""
    import torch.nn.functional as F
    q, k, v = args
    q4, k4, v4 = q[None], k[None], v[None]
    return (lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True)[0], [q, k, v])


LIBRARY = {"gru_cell": library_gru_cell,
           "neighbor_attn": library_neighbor_attn,
           "flash_attn": library_flash_attn}

# phase groups, in the order they run; `--only` picks some
PHASES = ("edge", "serve-config", "serve-production", "serve-config-apan",
          "serve-production-apan", "serve-config-rnn", "serve-production-rnn",
          "serve-config-jodie", "serve-production-jodie", "serve-parity",
          "train-config", "cli", "train-production", "train-config-pipe",
          "train-config-dense", "train-config-apan", "train-config-rnn",
          "train-config-rnn-std", "train-config-time", "train-config-jodie",
          "train-config-buckets", "train-config-pipe-buckets",
          "train-config-plain", "cli-new", "cli-time", "cli-jodie",
          "cli-plain", "cli-ckpt", "cli-csv", "train-production-pipe", "train-production-dense",
          "train-production-apan", "train-production-rnn",
          "train-production-jodie", "zoo-qwen3", "zoo-xlstm", "cli-zoo")


def kernel_row(name, spec, phase, inputs, counts):
    """Check the kernel on the inputs its phase captured, time it, its
    plain version and (where one exists) the library yardstick, and set
    the bound beside them."""
    import torch
    from repro_torch.kernels import ops
    _, a, kw = inputs[name]
    err = check_kernel(name, a, kw, f"{phase} inputs")
    copies = [x.clone() for x in a]
    run = lambda: ops.dispatch(name, *copies, mode="compiled", **kw)
    ms = time_ms(run)
    parts = {}
    dev_ms = device_ms(run, by_kernel=parts)
    plain_ms = time_ms(lambda: ops.dispatch(name, *copies, mode="oracle",
                                            **kw))
    library_ms = lib_dev_ms = None
    if name in LIBRARY:
        lib, lib_args = LIBRARY[name](copies)
        out = lib()
        if out.dtype == torch.bfloat16:
            # SDPA rounds its probabilities to bf16 before the product
            # with v: held to 2^-6 of the output's scale (a few bf16 ulps;
            # the kernel, which splits them into two bf16 parts, to one
            # ulp)
            want32 = ops.dispatch(name, *[x.float() for x in lib_args],
                                  mode="oracle", **kw)
            lib_err = float((out.float() - want32).abs().max())
            ok = lib_err <= 2 ** -6 * max(1.0, float(want32.abs().max()))
        else:
            want = ops.dispatch(name, *lib_args, mode="oracle", **kw)
            lib_err = float((out - want).abs().max())
            ok = lib_err <= TOL[name] * max(1.0, float(want.abs().max()))
        require(ok, f"{name}: the library yardstick differs by {lib_err}")
        library_ms = time_ms(lib)
        lib_dev_ms = device_ms(lib)
    b_ms, b_by = bound(name, a, kw)
    row = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": spec.replaces, "launches": counts[name],
           "max_abs_err": err, "tol": TOL[name], "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "library_device_ms": lib_dev_ms, "shape": shape_of(name, a)}
    if len(parts) > 1:
        # a call of several kernels (the table kernel's two phases): each
        row["device_ms_by_kernel"] = parts
    if name in ("memory_update_table", "memory_update", "ssd_chunk",
                "link_score"):
        # the bound with every operation on the fp32 units (fp32_flops)
        nbytes = work(name, a, kw)[0]
        row["fp32_bound_ms"] = max(nbytes / PEAK_BYTES,
                                   fp32_flops(name, a) / PEAK_FP32) * 1e3
    if name == "embed_attn":
        # the fold runs at every shape; the bound of the form before it
        nbytes, flops = direct_work(a)
        row.update(kernel_route="fold", U=a[1].shape[0],
                   direct_bound_ms=max(nbytes / PEAK_BYTES,
                                       flops / PEAK_FP32) * 1e3)
    if name == "flash_attn":
        # which of its two kernels ran, the products' rate and the share of
        # the bound (at the bf16 tensor-core peak for bf16 inputs)
        from repro_torch.kernels import flash_attn as fa
        route = fa.ROUTES[a[0].dtype]
        g, s_, d = a[0].shape
        prod = 4 * d * g * attn_pairs(s_, a[1].shape[1],
                                      kw.get("causal", True), kw.get("window"))
        row.update(source=FLASH_SOURCES[route], kernel_route=route,
                   tflops=prod / (ms * 1e-3) / 1e12, bound_share=b_ms / ms)
    if name == "memory_update":
        # the fusion's yardstick: the gru_cell and pres_filter kernels in
        # turn on the same inputs
        x, h, w, u, b, dm, scale, gamma = copies
        row["composed_ms"] = time_ms(lambda: ops.pres_filter(
            h, ops.gru_cell(x, h, w, u, b, mode="compiled"), dm, scale,
            gamma, mode="compiled", **kw))
    log(f"[kernel:{phase}] {json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the result lines as JSON to this file")
    ap.add_argument("--profile", type=int, default=0, metavar="TICKS",
                    help="also profile TICKS query+fold rounds of each "
                         "serve phase's engine, TICKS train steps of each "
                         "train phase and one prefill of each zoo phase, "
                         "after the kernel rows")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the zoo phases' weights and tokens")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (default: all): "
                         + ", ".join(PHASES) + "; the kernel rows then "
                         "cover the kernels those phases captured")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(PHASES)
    unknown = only - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
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
    check_tensor_core_build(_build.build().parent)

    seconds = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"[{name}] phase took {seconds[name]}s")
        return out

    # 3. edge shapes
    if "edge" in only:
        for name, a, kw, label in edge_cases(dev):
            err = check_kernel(name, a, kw, label)
            log(f"[edge] {name} {label}: max_abs_err={err:.3g}")

    from repro_torch.configs import tgn_pres
    from repro_torch.graph import datasets
    spec = datasets.SPECS["wiki-small"]
    wiki = datasets.get_dataset("wiki-small", 0)
    _, wiki_serve = wiki.train_serve_split(0.3)
    wiki_dst = (spec.n_users, spec.n_users + spec.n_items)
    rp = lambda c, **kw: dataclasses.replace(c, **kw)
    # the paper model's configs, cut in scale only: n_nodes from the graph
    # that runs them (wiki-small's 1,000; stream-small's 120,000 where
    # PRODUCTION names 1,048,576), d_edge from the dataset (16 in both;
    # PRODUCTION names 172), no event store (event_store=None: the port has
    # none yet, ROADMAP Queue 1 item 17), and the kernels on
    # (use_kernels=True); every width is the published one
    cfg = rp(tgn_pres.CONFIG, n_nodes=wiki.num_nodes, d_edge=wiki.feat_dim,
             use_kernels=True)
    sspec = datasets.STREAM_SPECS["stream-small"]
    n_events = 307_200
    stream = None
    if any(p.endswith("production") or "production-" in p for p in only):
        stream = datasets.stream_events(sspec, 0, n_events + 11_000)
    s_dst = (sspec.n_users, sspec.num_nodes)
    pcfg = rp(tgn_pres.PRODUCTION, n_nodes=sspec.num_nodes,
              d_edge=sspec.feat_dim, event_store=None, use_kernels=True)
    apan = dict(variant="apan")
    dense = dict(dedup_embed=False)
    pipe = dict(pipeline_depth=2)
    jodie = dict(variant="jodie")
    # kernel name -> {"config" / "production": (captured inputs, counts)}
    captured = {}

    def keep(names, phase, inputs, counts):
        for n in names:
            if n in inputs:
                captured.setdefault(n, {})[phase] = (inputs, counts)

    # 4-5. serve at CONFIG widths on wiki-small (then the same replay
    # through the plain versions), PRODUCTION on stream-small
    serve_sum = {}
    rnn = dict(memory_cell="rnn")

    def serve(label, c, phase, expect, capture=(), key=None):
        if label not in only:
            return
        prod = phase == "production"
        run = (dict(stream=stream, dst_range=s_dst, rate=100_000.0,
                    tick=1000 / 100_000.0, max_events=n_events,
                    topk_src=stream.src[:16], oracle_replay=False,
                    probe=1000) if prod else
               dict(stream=wiki_serve, dst_range=wiki_dst, rate=5000.0,
                    tick=200 / 5000.0, max_events=5000,
                    topk_src=wiki_serve.src[:8], oracle_replay=True,
                    probe=200))
        counts, inputs, serve_sum[label] = timed(
            label, serve_phase, label, c, dev=dev, query_batch=32, k=10,
            big_query=1024, expect=expect, profile=args.profile, **run)
        keep(capture, key or phase, inputs, counts)

    serve("serve-config", cfg, "config", SERVE_KERNELS, SERVE_KERNELS)
    serve("serve-production", pcfg, "production", SERVE_KERNELS,
          SERVE_KERNELS)
    serve("serve-config-apan", rp(cfg, **apan), "config", APAN_SERVE_KERNELS)
    serve("serve-production-apan", rp(pcfg, **apan), "production",
          APAN_SERVE_KERNELS)
    serve("serve-config-rnn", rp(cfg, **rnn), "config", RNN_SERVE_KERNELS)
    serve("serve-production-rnn", rp(pcfg, **rnn), "production",
          RNN_SERVE_KERNELS, ("pres_filter",), key="serve-production")
    serve("serve-config-jodie", rp(cfg, **jodie), "config",
          JODIE_SERVE_KERNELS)
    serve("serve-production-jodie", rp(pcfg, **jodie), "production",
          JODIE_SERVE_KERNELS)
    if "serve-parity" in only:
        # the offline-parity gate at CONFIG widths on wiki-small's first
        # 6,400 events (100 batches of 64)
        serve_sum["serve-parity"] = timed(
            "serve-parity", parity_phase, "serve-parity", cfg,
            wiki.slice(0, 6400), wiki_dst, dev)

    # 6-8. training: one epoch + evaluate at CONFIG widths on wiki-small
    # (compared with the plain route), 40 steps at PRODUCTION widths on the
    # first 41,000 stream-small events
    train_s, val_s, _ = wiki.chronological_split()
    head = stream.slice(0, 41_000) if stream is not None else None
    train_sum = {}

    def train(label, c, phase, expect, capture=(), against=None,
              noise_floor=False):
        prod = phase == "production"
        counts, inputs, train_sum[label] = timed(
            label, train_phase, label, c, head if prod else train_s,
            None if prod else val_s, s_dst if prod else wiki_dst, dev,
            batch_size=1000 if prod else 500, n_batches=41 if prod else None,
            expect=expect, oracle_steps=3 if prod else None, capture=capture,
            profile=args.profile, against=against, noise_floor=noise_floor)
        keep(capture, phase, inputs, counts)
        if "memory_update" in capture:
            # the dense op on this phase's occurrences, counted on its own
            label = f"op-memory-update-{phase}"
            counts = timed(label, op_phase, label, "memory_update", inputs)
            keep(("memory_update",), phase, inputs, counts)

    pres_path = ("memory_update_table", "embed_attn")
    std_path = ("gru_cell", "embed_attn")
    na_path = ("memory_update_table", "neighbor_attn")
    pipe_path = pres_path + ("pres_predict",)
    rnn_path = ("pres_filter", "embed_attn")
    if "train-config" in only:
        train("train-config-pres", cfg, "config", pres_path,
              capture=("memory_update",))
        train("train-config-std", rp(cfg, use_pres=False), "config",
              std_path, capture=("gru_cell",))
    cli = ["--dataset", "wiki-small", "--model", "tgn", "--use-kernels",
           "--epochs", "1"]

    def cli_run(label, argv, expect):
        train_sum[label] = timed(f"train-{label}", cli_phase,
                                 f"train-{label}", cli + argv, expect)

    if "cli" in only:
        cli_run("cli-pres", ["--pres"], pres_path)
        cli_run("cli-std", [], std_path)
    if "train-production" in only:
        train("train-production-pres", pcfg, "production", pres_path,
              capture=("memory_update",))
        train("train-production-std", rp(pcfg, use_pres=False),
              "production", std_path, capture=("gru_cell",))
    if "train-config-pipe" in only:
        train("train-config-pipe-d1", rp(cfg, pipeline_depth=1), "config",
              pipe_path)
        train("train-config-pipe", rp(cfg, **pipe), "config", pipe_path,
              capture=("pres_predict",))
    if "train-config-dense" in only:
        train("train-config-dense", rp(cfg, **dense), "config", na_path,
              capture=("neighbor_attn",))
    if "train-config-apan" in only:
        train("train-config-apan", rp(cfg, **apan), "config", na_path)
    if "train-config-rnn" in only:
        train("train-config-rnn", rp(cfg, **rnn), "config", rnn_path,
              capture=("pres_filter",))
    if "train-config-rnn-std" in only:
        train("train-config-rnn-std", rp(cfg, use_pres=False, **rnn),
              "config", ("embed_attn",))
    if "train-config-time" in only:
        train("train-config-time", rp(cfg, pres_scale="time",
                                      aggregator="mean", **pipe),
              "config", pipe_path)
    if "train-config-jodie" in only:
        # JODIE's free-running run moves by more than the limits when the
        # plain route's table is perturbed at the size of a kernel's
        # rounding: its free-running gaps are held to the limits beyond
        # that spread (the per-step check, every step from the same state,
        # is unchanged)
        train("train-config-jodie", rp(cfg, **jodie), "config",
              ("memory_update_table",), noise_floor=True)
        train("train-config-jodie-std", rp(cfg, use_pres=False, **jodie),
              "config", ("gru_cell",), noise_floor=True)
    # Sec. 5.3's hashed trackers at |V| / 16 (buckets_ablation.py's point)
    buckets = dict(pres_buckets=cfg.n_nodes // 16)
    if "train-config-buckets" in only:
        train("train-config-buckets", rp(cfg, **buckets), "config",
              pres_path)
    if "train-config-pipe-buckets" in only:
        train("train-config-pipe-buckets", rp(cfg, **buckets, **pipe),
              "config", pipe_path)
    if "train-config-plain" in only:
        # the reference's plain route: no kernel, held against the kernel
        # route of train-config-pres on the same batches and negatives
        train("train-config-plain", rp(cfg, use_kernels=False), "config",
              (), against=cfg)
    if "cli-new" in only:
        cli_run("cli-pipe", ["--pres", "--pipeline-depth", "2"], pipe_path)
        cli_run("cli-dense", ["--pres", "--no-dedup-embed"], na_path)
        train_sum["cli-apan"] = timed(
            "train-cli-apan", cli_phase, "train-cli-apan",
            ["--dataset", "wiki-small", "--model", "apan", "--use-kernels",
             "--epochs", "1", "--pres"], na_path)
    if "cli-time" in only:
        cli_run("cli-time", ["--pres", "--pres-scale", "time"], pres_path)
    if "cli-jodie" in only:
        cli_run("cli-jodie", ["--pres", "--model", "jodie"],
                ("memory_update_table",))
    if "cli-plain" in only:
        # no --use-kernels: the plain route, no launch
        train_sum["cli-plain"] = timed(
            "train-cli-plain", cli_phase, "train-cli-plain",
            ["--dataset", "wiki-small", "--model", "tgn", "--epochs", "1",
             "--pres"], ())
    if "cli-ckpt" in only:
        train_sum["cli-ckpt"] = timed(
            "cli-ckpt", cli_ckpt_phase, "cli-ckpt", cfg, wiki_serve,
            wiki_dst, dev, pres_path)
    if "cli-csv" in only:
        train_sum["cli-csv"] = timed("cli-csv", cli_csv_phase, "cli-csv",
                                     pres_path)
    if "train-production-pipe" in only:
        train("train-production-pipe", rp(pcfg, **pipe), "production",
              pipe_path, capture=("pres_predict",))
    if "train-production-dense" in only:
        train("train-production-dense", rp(pcfg, **dense), "production",
              na_path, capture=("neighbor_attn",))
    if "train-production-apan" in only:
        train("train-production-apan", rp(pcfg, **apan), "production",
              na_path)
    if "train-production-rnn" in only:
        train("train-production-rnn", rp(pcfg, **rnn), "production",
              rnn_path, capture=("pres_filter",))
    if "train-production-jodie" in only:
        train("train-production-jodie", rp(pcfg, **jodie), "production",
              ("memory_update_table",))

    # 9. the model zoo at full width: prefill (the zoo's kernels) and
    # decode, then the decode CLI
    zoo_sum = {}
    for label in ZOO:
        if label in only:
            counts, inputs, zoo_sum[label] = timed(
                label, zoo_phase, label, dev, args.seed,
                profile=args.profile)
            keep((ZOO[label][1],), "zoo", inputs, counts)
    if "cli-zoo" in only:
        for arch in ("qwen3-0.6b", "xlstm-350m"):
            zoo_sum[f"cli-zoo-{arch}"] = timed(
                f"cli-zoo-{arch}", cli_zoo_phase, f"cli-zoo-{arch}", arch,
                16)

    # 10. kernels on the inputs their phases handed them
    rows, more_rows = [], []
    for name, spec_ in ops.REGISTRY.items():
        for phase, (inputs, counts) in captured.get(name, {}).items():
            row = kernel_row(name, spec_, phase, inputs, counts)
            (rows if phase in ("config", "zoo") else more_rows).append(row)
    if only == set(PHASES):
        names = sorted(ops.REGISTRY)
        require(sorted(r["name"] for r in rows) == names
                and sorted({r["name"] for r in more_rows})
                == sorted(set(names) - set(ZOO_KERNELS)),
                f"kernel rows for {sorted(r['name'] for r in rows)} only")
    for run_profile in DEFERRED_PROFILES:
        run_profile()
    DEFERRED_PROFILES.clear()
    log(f"[seconds] {json.dumps(seconds)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "more_kernel_rows": more_rows,
             "serve": serve_sum, "train": train_sum, "zoo": zoo_sum,
             "profiles": PROFILES, "seconds": seconds},
            indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
