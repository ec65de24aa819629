"""One-epoch memory-parallel training runner (counterpart of
`repro/train/mesh_check.py`).

Runs a fixed synthetic workload for a given engine and shard count, then
reports the final natural-layout model state, the train AP and the
steady-state events/sec. The workload is deterministic in everything but
the shard count: same synthetic stream, same initial parameters and
state, same per-step negatives (drawn from one torch generator), so
`--n-shards 1` against `--n-shards K` isolates the routing protocol
(train/routing.py) and its collectives. One process drives every shard,
so no flag is needed before the run:

    PYTHONPATH=src python -m repro_torch.train.mesh_check \\
        --engine sequential --n-shards 4 --device cpu

The shards go on `--device` (`cpu`, or one card such as `cuda:0`); with
the default bare `cuda` shard i goes on `cuda:i`. Prints one JSON line
(ap, events_per_sec, route_overflow, ...) to stdout; `--out x.npz`
also saves the final natural-layout state (dump rows dropped, under the
JAX runner's `keystr` names) and the per-epoch APs."""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "pipelined", "scanned"])
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--shard-budget", type=int, default=None,
                    help="static per-(sender, owner) routing-lane budget; "
                         "default derives the overflow-free bound")
    ap.add_argument("--variant", default="tgn",
                    choices=["tgn", "jodie", "apan"])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--users", type=int, default=50)
    ap.add_argument("--items", type=int, default=30)
    ap.add_argument("--events", type=int, default=300)
    ap.add_argument("--batch", type=int, default=75)
    ap.add_argument("--d-mem", type=int, default=8)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="depth used when --engine pipelined")
    ap.add_argument("--scan-chunk", type=int, default=2,
                    help="chunk used when --engine scanned")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the shards go: cpu, one card (cuda:0), or "
                         "by default shard i on cuda:i")
    ap.add_argument("--out", default=None, help="npz path for the final "
                    "natural-layout state + per-epoch APs")
    return ap


def flat_state(state) -> dict:
    """A natural-layout state as {JAX keystr path: numpy array}, the dump
    rows dropped (the JAX runner's `_flat_state` names)."""
    from repro_torch import bridge
    out = {}
    for comp, leaves in bridge.state_to_numpy(state).items():
        dataclass_node = comp in ("memory", "pres")
        for k, v in leaves.items():
            out[f"['{comp}']" + (f".{k}" if dataclass_node else f"['{k}']")] \
                = v
    return out


def run(args) -> dict:
    from repro_torch.graph import datasets
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.models import mdgnn
    from repro_torch.models.mdgnn import MDGNNConfig
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline, routing, scan

    mesh = routing.get_mesh(args.n_shards, args.device)
    dev = mesh[0]
    spec = datasets.SyntheticSpec("mesh", args.users, args.items,
                                  args.events, 8)
    stream = datasets.generate(spec, seed=args.seed)
    kw = dict(variant=args.variant, n_nodes=stream.num_nodes,
              d_edge=stream.feat_dim, d_mem=args.d_mem, d_msg=args.d_mem,
              d_time=8, d_embed=args.d_mem, n_neighbors=4, use_pres=True,
              use_kernels=args.use_kernels, n_shards=args.n_shards,
              shard_budget=args.shard_budget)
    if args.engine == "pipelined":
        kw["pipeline_depth"] = args.pipeline_depth
    elif args.engine == "scanned":
        kw["scan_chunk"] = args.scan_chunk
    cfg = MDGNNConfig(**kw)

    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(args.seed),
                               dev)
    state = mdgnn.init_state(cfg, dev)
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    if cfg.n_shards > 1:
        state = routing.shard_state(cfg, state, mesh)
    batches = stream.temporal_batches(args.batch, dev)
    dst_range = (spec.n_users, spec.n_users + spec.n_items)
    gen = torch.Generator(dev).manual_seed(7)
    # the same draws at every shard count and engine: drawn up front
    negs = [[sample_negatives(gen, b, *dst_range) for b in batches[1:]]
            for _ in range(args.epochs)]

    if args.engine == "scanned":
        engine = scan.ScanEngine(cfg, opt)

        def run_one(params, opt_state, state, epoch):
            return engine.run_epoch(params, opt_state, state, batches, gen,
                                    dst_range, negatives=negs[epoch])
    else:
        step = pipeline.make_train_step(cfg, opt)

        def run_one(params, opt_state, state, epoch):
            return pipeline.run_epoch(params, opt_state, state, batches,
                                      cfg, step, gen, dst_range,
                                      negatives=negs[epoch])

    aps, secs, overflow = [], [], 0
    for epoch in range(args.epochs):
        params, opt_state, state, res = run_one(params, opt_state, state,
                                                epoch)
        aps.append(res.ap)
        secs.append(res.seconds)
        overflow += res.route_overflow

    if cfg.n_shards > 1:
        state = routing.unshard_state(cfg, state)
    events_per_epoch = (len(batches) - 1) * args.batch
    # min over epochs: the first epoch pays the warm-up, so with
    # --epochs >= 2 this is the steady-state throughput
    report = {
        "engine": args.engine, "n_shards": args.n_shards,
        "variant": args.variant, "use_kernels": bool(args.use_kernels),
        "devices": len(set(mesh)),
        "events_per_epoch": events_per_epoch,
        "epoch_seconds": [round(s, 4) for s in secs],
        "events_per_sec": round(events_per_epoch / min(secs), 2),
        "ap": float(aps[-1]),
        "aps": [float(a) for a in aps],
        "route_overflow": overflow,
    }
    if args.out:
        np.savez(args.out, __ap=np.asarray(aps, np.float64),
                 **flat_state(state))
    return report


def main(argv=None):
    report = run(build_argparser().parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
