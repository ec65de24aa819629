"""End-to-end MDGNN training entry point (counterpart of
`repro/launch/train.py`, the paper's experiment loop): Alg. 2 with
`--pres`, Alg. 1 without; `--model jodie` for JODIE's time projection,
`--model apan` for APAN's mailbox embedding, `--no-dedup-embed` for TGN's
dense embedding expansion, and `--pipeline-depth N` (N >= 1) for the
staleness-aware pipelined schedule, whose batches are carved on a prefetch
thread. `--use-kernels` runs the CUDA kernels; without it the step takes
the reference's plain route, which launches none, as the JAX CLI runs
without Pallas kernels. `--csv PATH` trains on a file of the public JODIE
format (`events.load_jodie_csv`) instead of `--dataset`; `--checkpoint
PATH` saves the {"params", "state"} bundle after the last epoch, in the
JAX package's file format (`checkpoint/io.py`), for the serve CLI's
`--checkpoint` (or the JAX package's) to restore.

    PYTHONPATH=src python -m repro_torch.launch.train --dataset wiki-small \
        --model tgn --pres --use-kernels --checkpoint /tmp/wiki.ckpt

Each epoch trains over the chronological train split, then evaluates on
the validation split from the trained state, and prints loss, train AP,
val AP, val AUC and seconds; `--json-out` writes the config and history.

It keeps the JAX CLI's flags that this path needs. The others raise
NotImplementedError naming the ROADMAP item that ports them, and so does
any model configuration outside the ported slices
(mdgnn.check_supported). It runs on CUDA unless `--device cpu` is given.
Parameters and negatives are drawn from `--seed` with torch generators,
not jax.random, so a run is not the JAX run's bit for bit."""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import bridge
from repro_torch.checkpoint import save_checkpoint
from repro_torch.device import resolve_device
from repro_torch.graph import datasets
from repro_torch.graph.datasets import SPECS
from repro_torch.graph.events import load_jodie_csv
from repro_torch.kernels import ops as kops
from repro_torch.models.mdgnn import (MDGNNConfig, check_supported,
                                      init_params, init_state)
from repro_torch.optim import adamw
from repro_torch.train import loop, pipeline

# flag -> the ROADMAP item that ports it
_NOT_YET = {
    "event_store": "Queue 1 item 17 (event store)",
    "scan_chunk": "Queue 1 item 15 (scan macro-batches)",
    "n_shards": "Queue 1 item 18 (memory parallelism)",
    "shard_budget": "Queue 1 item 18 (memory parallelism)",
    "metrics_out": "Queue 1 item 14 (obs/sink.py)",
    "trace_dir": "Queue 1 item 14 (obs/trace.py)",
}
# flags whose default means "off"
_OFF = {"scan_chunk": 1, "n_shards": 1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wiki-small", choices=list(SPECS))
    ap.add_argument("--csv", default=None,
                    help="path to a JODIE-format csv (in place of --dataset)")
    ap.add_argument("--event-store", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--model", default="tgn", choices=["tgn", "jodie", "apan"],
                    help="the embedding: TGN's attention, JODIE's time "
                         "projection or APAN's mailbox attention")
    ap.add_argument("--pres", action="store_true",
                    help="Alg. 2 (PRES); without it Alg. 1")
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--delta-mode", default="transition",
                    choices=["innovation", "transition"])
    ap.add_argument("--pres-scale", default="count", choices=["count", "time"],
                    help="Eq. 7 extrapolation scale: the node's count of "
                         "events in the batch, or the paper's t2 - t1")
    ap.add_argument("--batch-size", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d-mem", type=int, default=100)
    ap.add_argument("--n-layers", type=int, default=1,
                    help="embedding depth (hops of temporal attention)")
    ap.add_argument("--n-heads", type=int, default=2,
                    help="attention heads in the embedding stack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-dedup-embed", action="store_true",
                    help="TGN: embed over the dense seed expansion (M*K^d "
                         "rows a hop, attention through neighbor_attn) "
                         "instead of the deduplicated frontier (embed_attn)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route the memory step (memory_update_table with "
                         "--pres, gru_cell without), the embedding "
                         "attention (embed_attn, or neighbor_attn for APAN "
                         "and --no-dedup-embed) and the pipeline's "
                         "staleness fill (pres_predict) through the CUDA "
                         "kernels; without it the plain route, no kernel")
    ap.add_argument("--kernels-mode", default="auto",
                    choices=["auto", "compiled", "interpret", "oracle"],
                    help="auto: kernels on CUDA, plain versions on the CPU; "
                         "oracle pins the plain versions; interpret raises")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="staleness-aware pipelined schedule: the embedding "
                         "reads a memory snapshot at most this many "
                         "batch-writes stale, the in-flight rows filled by "
                         "PRES Eq. 7 (0 = the lag-one loop)")
    ap.add_argument("--scan-chunk", type=int, default=1,
                    help="not ported yet (raises unless 1)")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="not ported yet (raises unless 1)")
    ap.add_argument("--shard-budget", type=int, default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--checkpoint", default=None,
                    help="save the {params, state} bundle here after the "
                         "last epoch")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--metrics-out", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--trace-dir", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    args = ap.parse_args(argv)
    for flag, item in _NOT_YET.items():
        if getattr(args, flag) not in (_OFF.get(flag), False):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet; ROADMAP "
                f"{item} ports it")

    device = resolve_device(args.device)
    if args.csv:
        stream = load_jodie_csv(args.csv)
        dst_range = (0, stream.num_nodes)
    else:
        spec = SPECS[args.dataset]
        stream = datasets.get_dataset(args.dataset, args.seed)
        dst_range = (spec.n_users, spec.n_users + spec.n_items)
    train_s, val_s, _ = stream.chronological_split()
    cfg = MDGNNConfig(
        variant=args.model, n_nodes=stream.num_nodes, d_edge=stream.feat_dim,
        d_mem=args.d_mem, d_msg=args.d_mem, d_embed=args.d_mem,
        n_layers=args.n_layers, n_heads=args.n_heads,
        use_pres=args.pres, beta=args.beta, delta_mode=args.delta_mode,
        pres_scale=args.pres_scale, dedup_embed=not args.no_dedup_embed,
        use_kernels=args.use_kernels, kernels_mode=args.kernels_mode,
        pipeline_depth=args.pipeline_depth)
    check_supported(cfg)
    depth = cfg.pipeline_depth
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    state = init_state(cfg, device)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    train_step = pipeline.make_train_step(cfg, opt)
    eval_step = loop.make_eval_step(cfg)
    gen = torch.Generator(device).manual_seed(args.seed)
    # depth 0 trains from the materialised list; depth >= 1 re-carves the
    # batches each epoch on a prefetch thread, overlapping the carve and
    # the host-to-device copies with the steps
    if depth:
        make_batches = lambda: train_s.prefetch_batches(
            args.batch_size, device, depth=max(2, depth))
    else:
        batches = train_s.temporal_batches(args.batch_size, device)
        make_batches = lambda: batches
    val_batches = val_s.temporal_batches(args.batch_size, device)
    if cfg.use_kernels:
        print(f"[kernels] backend={device.type} mode={cfg.kernels_mode} "
              f"default={kops.resolve_mode('auto', device)}")
    print(f"[train] {args.model}{'-PRES' if args.pres else ''} on "
          f"{args.csv or args.dataset}: {len(train_s)} events, "
          f"K={train_s.num_batches(args.batch_size)} batches of "
          f"b={args.batch_size}"
          + (f", pipeline_depth={depth}" if depth else ""))
    history = []
    for epoch in range(args.epochs):
        params, opt_state, state, res = pipeline.run_epoch(
            params, opt_state, state, make_batches(), cfg, train_step, gen,
            dst_range)
        _, vap, vauc = loop.evaluate(params, state, val_batches, cfg,
                                     eval_step, gen, dst_range)
        history.append({"epoch": epoch, "train_ap": res.ap, "loss": res.loss,
                        "seconds": res.seconds, "val_ap": vap,
                        "val_auc": vauc})
        print(f"  epoch {epoch}: loss={res.loss:.4f} train_ap={res.ap:.4f} "
              f"val_ap={vap:.4f} val_auc={vauc:.4f} ({res.seconds:.1f}s)")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, bridge.mdgnn_bundle(params, state))
        print(f"[ckpt] saved to {args.checkpoint}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": dataclasses.asdict(cfg), "history": history},
                      f, indent=2, default=str)
    return history


if __name__ == "__main__":
    main()
