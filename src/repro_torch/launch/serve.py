"""Online MDGNN serving CLI (counterpart of `repro/launch/serve.py`).

Builds a ServeEngine with random parameters from `--seed` and drives it
with the Poisson arrival-clock replay over the stream's serving tail,
reporting p50/p99 ingest and query latency, events/sec and the online AP:

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset wiki-small \
        --model tgn --pres --use-kernels

It keeps the JAX CLI's flags. Flags this port cannot honour yet raise
NotImplementedError naming the ROADMAP item that ports them, and so does
any model configuration outside the ported slice (mdgnn.check_supported).
It runs on CUDA unless `--device cpu` is given."""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.graph import datasets
from repro_torch.graph.datasets import SPECS
from repro_torch.kernels import ops as kops
from repro_torch.models.mdgnn import MDGNNConfig, init_params, init_state
from repro_torch.serve import MicroBatcher, ServeEngine, replay

# flag -> the ROADMAP item that ports it
_NOT_YET = {
    "checkpoint": "Queue 1 item 10 (checkpoint/io.py)",
    "event_store": "Queue 1 item 17 (event store)",
    "zoo": "Queue 1 item 19 (zoo substrate)",
    "trace_dir": "Queue 1 item 14 (obs/trace.py)",
    "metrics_out": "Queue 1 item 14 (obs/sink.py)",
}


def serve_mdgnn(args):
    for flag, item in _NOT_YET.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet; ROADMAP "
                f"{item} ports it")
    device = resolve_device(args.device)
    spec = SPECS[args.dataset]
    stream = datasets.get_dataset(args.dataset, args.seed)
    dst_range = (spec.n_users, spec.n_users + spec.n_items)
    cfg = MDGNNConfig(variant=args.model, n_nodes=stream.num_nodes,
                      d_edge=stream.feat_dim, d_mem=args.d_mem,
                      d_msg=args.d_mem, d_embed=args.d_mem,
                      n_layers=args.n_layers, use_pres=args.pres,
                      use_kernels=args.use_kernels,
                      kernels_mode=args.kernels_mode)
    _, serve_s = stream.train_serve_split(args.serve_frac)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    engine = ServeEngine(cfg, params, init_state(cfg, device),
                         batcher=MicroBatcher(d_edge=stream.feat_dim),
                         item_range=dst_range, device=device)
    origin = "untrained params (checkpoints are not ported yet)"
    kops.reset_launch_counts()
    tick = args.batch_size / args.rate
    report = replay(engine, serve_s, dst_range, rate=args.rate, tick=tick,
                    query_batch=args.query_batch, seed=args.seed,
                    late_frac=args.late_frac, max_late=args.max_late,
                    max_events=args.max_events)
    print(f"[serve] {args.model}{'-PRES' if args.pres else ''} on "
          f"{args.dataset} ({origin})")
    default = kops.resolve_mode("auto", device)
    launches = " ".join(f"{k}={v}" for k, v in kops.launch_counts().items())
    print(f"  kernels: backend={device.type} mode={cfg.kernels_mode} "
          f"default={default} launches: {launches}")
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
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wiki-small", choices=list(SPECS))
    ap.add_argument("--event-store", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--model", default="tgn", choices=["tgn", "jodie", "apan"])
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
                         "kernels (required by this port)")
    ap.add_argument("--kernels-mode", default="auto",
                    choices=["auto", "compiled", "interpret", "oracle"],
                    help="auto: kernels on CUDA, plain versions on the CPU; "
                         "oracle pins the plain versions; interpret raises")
    ap.add_argument("--checkpoint", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--metrics-out", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--trace-dir", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--trace-steps", type=int, default=8,
                    help="tick window length for --trace-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zoo", default=None, help="not ported yet (raises)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    return serve_mdgnn(ap.parse_args(argv))


if __name__ == "__main__":
    main()
