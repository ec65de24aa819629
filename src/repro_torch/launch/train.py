"""End-to-end MDGNN training entry point (counterpart of
`repro/launch/train.py`, the paper's experiment loop): Alg. 2 with
`--pres`, Alg. 1 without; `--model jodie` for JODIE's time projection,
`--model apan` for APAN's mailbox embedding, `--no-dedup-embed` for TGN's
dense embedding expansion, `--pipeline-depth N` (N >= 1) for the
staleness-aware pipelined schedule and `--scan-chunk T` (T > 1) for
macro-batch training (train/scan.py: T lag-one steps a macro step, one
CUDA graph a macro where the step has no host sync). `--use-kernels`
runs the CUDA kernels; without it the step takes the reference's plain
route, which launches none, as the JAX CLI runs without Pallas kernels.
`--csv PATH` trains on a file of the public JODIE format
(`events.load_jodie_csv`) and `--event-store DIR` from an on-disk event
store (graph/store.py, windowed memory maps carved on a prefetch thread,
the batches bit-identical to the in-RAM carve) instead of `--dataset`;
`--checkpoint PATH` saves the {"params", "state"} bundle after the last
epoch, in the JAX package's file format (`checkpoint/io.py`), for the
serve CLI's `--checkpoint` (or the JAX package's) to restore.

    PYTHONPATH=src python -m repro_torch.launch.train --dataset wiki-small \
        --model tgn --pres --use-kernels --checkpoint /tmp/wiki.ckpt

Each epoch trains over the chronological train split, then evaluates on
the validation split from the trained state, and prints loss, train AP,
val AP, val AUC and seconds; `--json-out` writes the config and history.
Telemetry: `--metrics-out FILE` writes the JSONL run-log (obs/sink.py: a
manifest, an epoch record with the per-step obs series fetched once an
epoch, GMM tracker health, host spans and the kernel-dispatch table),
which the JAX package's `tools/inspect_run.py` renders; `--trace-dir DIR`
captures a `torch.profiler` trace of the first `--trace-steps` step (or
macro-step) calls.

`--n-shards N` (N > 1) trains memory-parallel (train/routing.py): the
node tables are sharded by node id % N, one process drives every shard,
and the touched rows are routed to their owners each step; the shards
go on `--device` (`cpu`, or one card such as `cuda:0`) or, with the
default bare `cuda`, shard i on `cuda:i` (a ValueError names the visible
count when fewer cards are visible). `--shard-budget` tightens the
per-lane routing budget (overflow counted in the run-log). The
checkpoint is written in the natural single-device layout.

It keeps the JAX CLI's flags. It runs on CUDA unless `--device cpu` is
given.
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
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.models.mdgnn import (MDGNNConfig, check_supported,
                                      init_params, init_state)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sink
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw
from repro_torch.train import loop, pipeline, routing, scan


def kernels_line(device, mode: str) -> str:
    """JAX's policy line: the device's backend, the configured mode, the
    resolved default (the env var's where set) and the autotune entries
    the device's backend reads."""
    return (f"backend={device.type} mode={mode} "
            f"default={kops.resolve_mode('auto', device)} "
            f"autotune_entries={autotune.n_entries(device.type)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wiki-small", choices=list(SPECS))
    ap.add_argument("--csv", default=None,
                    help="path to a JODIE-format csv (in place of --dataset)")
    ap.add_argument("--event-store", default=None,
                    help="train from an on-disk event store directory "
                         "(python -m repro_torch.launch.convert_events): "
                         "windowed memory maps, batches bit-identical to "
                         "the in-RAM carve")
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
                    help="macro-batch training: T lag-one steps a macro "
                         "step, negatives drawn in the step, one CUDA graph "
                         "a macro where the step has no host sync; 1 = the "
                         "lag-one loop. Excludes --pipeline-depth >= 1")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="memory-parallel shards: every node-indexed table "
                         "partitioned by node_id %% n_shards, the touched "
                         "rows routed to their owners with one all_to_all "
                         "a step; the shards go on --device (cpu, or one "
                         "card such as cuda:0), or shard i on cuda:i with "
                         "the default")
    ap.add_argument("--shard-budget", type=int, default=None,
                    help="static per-(sender, owner) routing-lane budget; "
                         "default derives the overflow-free bound, smaller "
                         "values trade dropped updates (counted in "
                         "route_overflow) for smaller exchanges")
    ap.add_argument("--checkpoint", default=None,
                    help="save the {params, state} bundle here after the "
                         "last epoch")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--metrics-out", default=None,
                    help="write a JSONL run-log: manifest, per-epoch "
                         "records with the device-accumulated obs series, "
                         "GMM tracker health, host spans and the "
                         "kernel-dispatch table (tools/inspect_run.py)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the first "
                         "--trace-steps step calls into this directory")
    ap.add_argument("--trace-steps", type=int, default=8,
                    help="step-call window of --trace-dir")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    args = ap.parse_args(argv)

    mesh = (routing.get_mesh(args.n_shards, args.device)
            if args.n_shards > 1 else None)
    device = mesh[0] if mesh else resolve_device(args.device)
    streamed = args.event_store is not None
    if streamed:
        from repro_torch.graph.store import EventStore
        est = EventStore.open(args.event_store)
        stream = est.stream()
        dst_range = est.dst_range()
    elif args.csv:
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
        pipeline_depth=args.pipeline_depth, scan_chunk=args.scan_chunk,
        event_store=args.event_store, n_shards=args.n_shards,
        shard_budget=args.shard_budget,
        obs_metrics=args.metrics_out is not None)
    check_supported(cfg)
    scan.check_schedule(cfg)
    depth = cfg.pipeline_depth
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    state = init_state(cfg, device)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    if mesh:
        # the node tables in the shard-major layout on their shards; the
        # parameters and the optimizer stay on the controller (shard 0's
        # device), and the engines route behind cfg.n_shards
        state = routing.shard_state(cfg, state, mesh)
        print(f"[dist] memory-parallel over {cfg.n_shards} shards "
              f"({len(set(mesh))} device(s): {mesh[0]}"
              f"{' ..' if len(set(mesh)) > 1 else ''}, "
              f"budget={cfg.shard_budget or 'auto'})")
    runlog = None
    if args.metrics_out:
        obs_trace.enable()
        runlog = sink.RunLog(args.metrics_out, role="train", cfg=cfg,
                             argv=argv)
    tracer = (obs_trace.StepTraceCapture(args.trace_dir,
                                         n_steps=args.trace_steps)
              if args.trace_dir else None)
    hook = tracer.wrap if tracer else None
    engine = (scan.ScanEngine(cfg, opt, step_hook=hook)
              if cfg.scan_chunk > 1 else None)
    train_step = None if engine else pipeline.make_train_step(cfg, opt)
    if hook is not None and train_step is not None:
        train_step = hook(train_step)
    eval_step = loop.make_eval_step(cfg)
    gen = torch.Generator(device).manual_seed(args.seed)
    # the lag-one loop and scan train from the materialised list; the
    # pipelined schedule and a store re-carve the batches each epoch on a
    # prefetch thread (a store's windows are mapped there), overlapping the
    # carve and the host-to-device copies with the steps
    if streamed or depth:
        make_batches = lambda: train_s.prefetch_batches(
            args.batch_size, device, depth=max(2, depth))
    else:
        batches = train_s.temporal_batches(args.batch_size, device)
        make_batches = lambda: batches
    if streamed:
        make_val = lambda: val_s.iter_temporal_batches(args.batch_size,
                                                       device)
    else:
        val_batches = val_s.temporal_batches(args.batch_size, device)
        make_val = lambda: val_batches
    if cfg.use_kernels:
        print(f"[kernels] {kernels_line(device, cfg.kernels_mode)}")
    source = (f"store {args.event_store}" if streamed
              else args.csv or args.dataset)
    print(f"[train] {args.model}{'-PRES' if args.pres else ''} on "
          f"{source}: {len(train_s)} events, "
          f"K={train_s.num_batches(args.batch_size)} batches of "
          f"b={args.batch_size}"
          + (f", pipeline_depth={depth}" if depth else "")
          + (f", scan_chunk={cfg.scan_chunk}" if cfg.scan_chunk > 1 else ""))
    history = []
    for epoch in range(args.epochs):
        if engine is not None:
            params, opt_state, state, res = engine.run_epoch(
                params, opt_state, state, make_batches(), gen, dst_range)
        else:
            params, opt_state, state, res = pipeline.run_epoch(
                params, opt_state, state, make_batches(), cfg, train_step,
                gen, dst_range)
        _, vap, vauc = loop.evaluate(params, state, make_val(), cfg,
                                     eval_step, gen, dst_range)
        history.append({"epoch": epoch, "train_ap": res.ap, "loss": res.loss,
                        "seconds": res.seconds, "val_ap": vap,
                        "val_auc": vauc})
        if runlog is not None:
            rec = {"epoch": epoch, "loss": res.loss, "train_ap": res.ap,
                   "val_ap": vap, "val_auc": vauc, "seconds": res.seconds,
                   "route_overflow": res.route_overflow}
            if res.obs is not None:
                rec.update(steps=res.obs["steps"], series=res.obs["series"])
                ev = sum(res.obs["series"].get("events", []))
                if res.seconds > 0:
                    rec["events_per_sec"] = ev / res.seconds
                if "route_overflow_shards" in res.obs:
                    rec["route_overflow_shards"] = \
                        res.obs["route_overflow_shards"]
            if cfg.use_pres and cfg.n_shards == 1:
                rec["gmm_health"] = obs_metrics.gmm_health(state["pres"])
            if engine is not None:
                rec["scan_captured"] = engine.captured
            runlog.write("epoch", **rec)
        print(f"  epoch {epoch}: loss={res.loss:.4f} train_ap={res.ap:.4f} "
              f"val_ap={vap:.4f} val_auc={vauc:.4f} ({res.seconds:.1f}s)")
    if tracer is not None:
        tracer.stop()
    if mesh:
        # the natural single-device layout, so that an unsharded run (the
        # serve CLI, or the JAX package's) restores the checkpoint
        state = routing.unshard_state(cfg, state)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, bridge.mdgnn_bundle(params, state))
        print(f"[ckpt] saved to {args.checkpoint}")
    if runlog is not None:
        # the epilogue: host spans, the kernel-dispatch table, the end
        runlog.close()
        obs_trace.disable()
        print(f"[obs] run-log written to {args.metrics_out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": dataclasses.asdict(cfg), "history": history},
                      f, indent=2, default=str)
    return history


if __name__ == "__main__":
    main()
