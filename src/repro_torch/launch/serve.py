"""Online MDGNN serving CLI (counterpart of `repro/launch/serve.py`).

Builds a ServeEngine, from a training checkpoint when `--checkpoint` is
given (the train CLI's `--checkpoint` bundle, or the JAX package's; the
model flags must match the training run's), else with random parameters
from `--seed`, and drives it with the Poisson arrival-clock replay over
the stream's serving tail, reporting p50/p99 ingest and query latency,
events/sec and the online AP:

    PYTHONPATH=src python -m repro_torch.launch.train --dataset wiki-small \
        --pres --use-kernels --checkpoint /tmp/wiki.ckpt
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset wiki-small \
        --pres --use-kernels --checkpoint /tmp/wiki.ckpt

On the card the engine captures its bodies as CUDA graphs per bucket
(`serve/engine.py`: query and top-k always, the fold where it has no host
sync).

`--model apan` serves APAN (mailbox attention through `neighbor_attn`),
`--model jodie` JODIE (its time projection; the memory stage and top-k
run the kernels). Without `--use-kernels` every call takes the
reference's plain route and launches no kernel, as the JAX CLI runs
without Pallas kernels. `--zoo <arch> --steps N` runs
the model zoo's greedy decode loop instead (any of `configs.ARCH_IDS`,
its reduced config, batch 2, a 128-slot cache; whisper's encoder runs
first on random frame embeddings), as the JAX CLI does; decode runs no
kernel (the zoo's kernels run in the prefill, `Model.prefill`):

    PYTHONPATH=src python -m repro_torch.launch.serve --zoo zamba2-1.2b \
        --steps 16

`--event-store DIR` serves the tail of an on-disk event store (its
node space and item range) in place of `--dataset`. Telemetry:
`--metrics-out FILE` writes the JSONL run-log (a manifest, one "serve"
record with the counters and the whole ingest and query latency
histograms, host spans, the kernel-dispatch table), and `--trace-dir DIR`
captures a `torch.profiler` trace of the first `--trace-steps` ingest
calls.

It keeps the JAX CLI's flags. A value no configuration defines raises
ValueError (mdgnn.check_supported), and so does a sharded configuration:
serving has no sharded path, as in JAX (a sharded run's checkpoint is
written in the natural layout and serves as any other). It runs on CUDA
unless `--device cpu` is given."""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.graph import datasets
from repro_torch.graph.datasets import SPECS
from repro_torch.kernels import ops as kops
from repro_torch.launch.train import kernels_line
from repro_torch.models.mdgnn import MDGNNConfig, init_params, init_state
from repro_torch.obs import sink
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import MicroBatcher, ServeEngine, replay


def serve_mdgnn(args):
    device = resolve_device(args.device)
    if args.event_store:
        from repro_torch.graph.store import EventStore
        est = EventStore.open(args.event_store)
        stream = est.stream()
        dst_range = est.dst_range()
    else:
        spec = SPECS[args.dataset]
        stream = datasets.get_dataset(args.dataset, args.seed)
        dst_range = (spec.n_users, spec.n_users + spec.n_items)
    cfg = MDGNNConfig(variant=args.model, n_nodes=stream.num_nodes,
                      d_edge=stream.feat_dim, d_mem=args.d_mem,
                      d_msg=args.d_mem, d_embed=args.d_mem,
                      n_layers=args.n_layers, use_pres=args.pres,
                      use_kernels=args.use_kernels,
                      kernels_mode=args.kernels_mode,
                      event_store=args.event_store)
    _, serve_s = stream.train_serve_split(args.serve_frac)
    batcher = MicroBatcher(d_edge=stream.feat_dim)
    if args.checkpoint:
        engine = ServeEngine.from_checkpoint(
            args.checkpoint, cfg, seed=args.seed, device=device,
            batcher=batcher, item_range=dst_range)
        origin = f"checkpoint {args.checkpoint}"
    else:
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device)
        engine = ServeEngine(cfg, params, init_state(cfg, device),
                             batcher=batcher, item_range=dst_range,
                             device=device)
        origin = "untrained params (pass --checkpoint for a trained model)"
    runlog = None
    if args.metrics_out:
        obs_trace.enable()
        runlog = sink.RunLog(args.metrics_out, role="serve", cfg=cfg)
    tracer = None
    if args.trace_dir:
        tracer = obs_trace.StepTraceCapture(args.trace_dir,
                                            n_steps=args.trace_steps)
        # each ingest call is one traced "step" of the replay window
        engine.ingest = tracer.wrap(engine.ingest)
    kops.reset_launch_counts()
    tick = args.batch_size / args.rate
    report = replay(engine, serve_s, dst_range, rate=args.rate, tick=tick,
                    query_batch=args.query_batch, seed=args.seed,
                    late_frac=args.late_frac, max_late=args.max_late,
                    max_events=args.max_events)
    if tracer is not None:
        tracer.stop()
    if runlog is not None:
        runlog.write(
            "serve", n_events=report.n_events, n_queries=report.n_queries,
            n_ticks=report.n_ticks, seconds=report.seconds,
            events_per_sec=report.events_per_sec,
            queries_per_sec=report.queries_per_sec,
            ingest_p50_ms=report.ingest_p50_ms,
            ingest_p99_ms=report.ingest_p99_ms,
            query_p50_ms=report.query_p50_ms,
            query_p99_ms=report.query_p99_ms,
            online_ap=report.online_ap, sim_seconds=report.sim_seconds,
            ingest_hist=report.ingest_hist, query_hist=report.query_hist,
            # keys prepared during the replay, "kind size[ k]": any entry
            # means a live request paid a capture
            post_warmup_traces={" ".join(map(str, k)): v for k, v in
                                report.post_warmup_traces.items()})
    source = (f"store {args.event_store}" if args.event_store
              else args.dataset)
    print(f"[serve] {args.model}{'-PRES' if args.pres else ''} on "
          f"{source} ({origin})")
    launches = " ".join(f"{k}={v}" for k, v in kops.launch_counts().items())
    print(f"  kernels: {kernels_line(device, cfg.kernels_mode)} "
          f"launches: {launches}")
    print(f"  stream: {report.n_events} events over "
          f"{report.sim_seconds:.1f}s simulated arrivals "
          f"(rate={args.rate:.0f} ev/s, {report.n_ticks} ticks)")
    print(f"  ingest: p50={report.ingest_p50_ms:.2f}ms "
          f"p99={report.ingest_p99_ms:.2f}ms, "
          f"{report.events_per_sec:.0f} events/sec end-to-end")
    print(f"  query : p50={report.query_p50_ms:.2f}ms "
          f"p99={report.query_p99_ms:.2f}ms, "
          f"{report.queries_per_sec:.0f} queries/sec, "
          f"online AP={report.online_ap:.4f}")
    if args.topk:
        srcs = serve_s.src[:min(8, len(serve_s))]
        ts = serve_s.t[:min(8, len(serve_s))]
        scores, items = engine.recommend_topk(srcs, ts, args.topk)
        print(f"  topk  : k={args.topk} for {len(srcs)} sources, e.g. "
              f"src {int(srcs[0])} -> items {items[0].tolist()}")
    if runlog is not None:
        # after the top-k, so its dispatches are in the table
        runlog.close()
        obs_trace.disable()
        print(f"[obs] run-log written to {args.metrics_out}")
    return report


def serve_zoo(arch: str, steps: int, device=None, seed: int = 0):
    """Greedy decode of `steps` tokens for a batch of 2 through an arch's
    reduced config, with random parameters from `seed`; an enc-dec arch
    (whisper) first encodes random frame embeddings from the same
    generator into the decode state, as JAX's `serve_zoo` does. Prints
    tokens/s and the device. Returns the (2, steps) generated tokens.
    Raises ValueError when `steps` exceeds the 128-slot cache."""
    from repro_torch.archs.api import get_model
    from repro_torch.configs import get_config

    b, cache_len = 2, 128
    if steps > cache_len:
        raise ValueError(f"serve_zoo: {steps} decode steps do not fit the "
                         f"cache (cache_len {cache_len})")
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(seed)
    params = model.init(gen, dev)
    tokens = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    out = []
    with torch.no_grad():
        state = model.init_decode_state(b, cache_len, dev)
        if model.encode is not None:    # enc-dec (whisper): encoder prefill
            feats = torch.randn((b, cfg.enc_frames, cfg.d_model),
                                generator=gen, device=dev).to(cfg.dtype)
            state["enc_out"] = model.encode(params, feats)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for pos in range(steps):
            logits, state = model.decode_step(params, state, tokens, pos)
            tokens = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    print(f"[serve-zoo] {arch} (reduced): {steps} decode steps, "
          f"{steps * b / dt:.1f} tok/s on {name}")
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wiki-small", choices=list(SPECS))
    ap.add_argument("--event-store", default=None,
                    help="serve from an on-disk event store directory "
                         "instead of --dataset; the replay tail stays "
                         "memory-mapped")
    ap.add_argument("--model", default="tgn", choices=["tgn", "jodie", "apan"],
                    help="the embedding: TGN's attention, JODIE's time "
                         "projection or APAN's mailbox attention")
    ap.add_argument("--pres", action="store_true")
    ap.add_argument("--n-layers", type=int, default=1,
                    help="embedding depth (hops for tgn)")
    ap.add_argument("--d-mem", type=int, default=100, help="memory width")
    ap.add_argument("--batch-size", type=int, default=200,
                    help="mean ingest micro-batch (sets the service tick "
                         "as batch-size/rate; the batcher buckets it)")
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="Poisson arrival intensity, events/sec")
    ap.add_argument("--query-batch", type=int, default=32,
                    help="positive queries sampled per service tick")
    ap.add_argument("--serve-frac", type=float, default=0.3,
                    help="tail fraction of the stream replayed as live "
                         "traffic")
    ap.add_argument("--late-frac", type=float, default=0.0,
                    help="fraction of events delivered out-of-order")
    ap.add_argument("--max-late", type=int, default=0,
                    help="bound (positions) on out-of-order delivery")
    ap.add_argument("--max-events", type=int, default=None,
                    help="cap on replayed events")
    ap.add_argument("--topk", type=int, default=0,
                    help="also demo recommend_topk with this k")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route ingest, query and top-k through the CUDA "
                         "kernels; without it the plain route, no kernel")
    ap.add_argument("--kernels-mode", default="auto",
                    choices=["auto", "compiled", "interpret", "oracle"],
                    help="auto: kernels on CUDA, plain versions on the CPU; "
                         "oracle pins the plain versions; interpret raises")
    ap.add_argument("--checkpoint", default=None,
                    help="restore the engine from this training checkpoint "
                         "(the model flags must match)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a JSONL run-log: manifest, a serve record "
                         "with counters and the ingest/query latency "
                         "histograms, host spans and the kernel-dispatch "
                         "table (tools/inspect_run.py)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the first "
                         "--trace-steps ingest calls into this directory")
    ap.add_argument("--trace-steps", type=int, default=8,
                    help="tick window length for --trace-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zoo", default=None,
                    help="run the model zoo's decode loop for this arch "
                         "(one of configs.ARCH_IDS)")
    ap.add_argument("--steps", type=int, default=16,
                    help="decode steps of --zoo")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    args = ap.parse_args(argv)
    if args.zoo:
        return serve_zoo(args.zoo, args.steps, args.device, args.seed)
    return serve_mdgnn(args)


if __name__ == "__main__":
    main()
