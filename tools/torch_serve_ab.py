"""Serving throughput of two checkouts of the PyTorch port, in ONE process.

    python3 tools/torch_serve_ab.py PARENT_ROOT CHANGE_ROOT [--passes 3]

Imports `repro_torch` from PARENT_ROOT/src and again from CHANGE_ROOT/src
(two module trees, two kernel libraries), builds a `ServeEngine` from each
at the serve CLI's defaults (wiki-small, TGN-PRES, the paper model's
widths, random weights from seed 0) and feeds both the same ticks: a query
of 32 positive and 32 negative pairs, then the ingest of the tick's 200
events, each block of ticks timed to a device sync. Blocks alternate
between the two engines, the first side switching every pair, so the
host's slow and fast spells fall on both alike; separate processes differ
by more than the change under test. Each pass starts from empty state.

Prints one JSON line: per side the block seconds, the median events/s and
the interquartile range; the pairs the change won; and after each pass the
largest difference between the two memory tables (the same model on the
same events: rounding only)."""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def load(root: pathlib.Path) -> dict:
    """The port's modules from `root`/src, under their own names."""
    src = str(root.resolve() / "src")
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        from repro_torch.graph import datasets
        from repro_torch.models import mdgnn
        from repro_torch.serve import MicroBatcher, ServeEngine
    finally:
        sys.path.remove(src)
    return {"datasets": datasets, "mdgnn": mdgnn, "batcher": MicroBatcher,
            "engine": ServeEngine}


def make_engine(mods, device):
    import torch
    mdgnn = mods["mdgnn"]
    stream = mods["datasets"].get_dataset("wiki-small", 0)
    cfg = mdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                            d_edge=stream.feat_dim, use_pres=True,
                            use_kernels=True)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), device)
    engine = mods["engine"](cfg, params, mdgnn.init_state(cfg, device),
                            batcher=mods["batcher"](d_edge=stream.feat_dim),
                            device=device)
    engine.warmup(query=True)
    spec = mods["datasets"].SPECS["wiki-small"]
    return engine, stream, cfg, (spec.n_users, spec.n_users + spec.n_items)


def run_block(engine, stream, items, lo, hi, tick, rng):
    import numpy as np
    t0 = time.perf_counter()
    for a in range(lo, hi, tick):
        b = min(a + tick, hi)
        pick = a + rng.choice(b - a, min(32, b - a), replace=False)
        neg = rng.integers(*items, len(pick))
        engine.query(np.concatenate([stream.src[pick], stream.src[pick]]),
                     np.concatenate([stream.dst[pick], neg]),
                     np.concatenate([stream.t[pick], stream.t[pick]]))
        engine.ingest(stream.src[a:b], stream.dst[a:b], stream.t[a:b],
                      stream.feat[a:b])
    engine.block_until_ready()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--events", type=int, default=20_000)
    ap.add_argument("--tick", type=int, default=200)
    ap.add_argument("--block", type=int, default=2_000,
                    help="events per timed block")
    ap.add_argument("--device", default="cuda:0",
                    help="with its index: engines compare tensor devices")
    args = ap.parse_args(argv)
    import numpy as np
    sides = {}
    for side in ("parent", "change"):
        mods = load(getattr(args, side))
        sides[side] = (mods, *make_engine(mods, args.device))
    secs = {"parent": [], "change": []}
    sizes, table_diff = [], []
    pair = 0
    for _ in range(args.passes):
        for mods, eng, _, cfg, _ in sides.values():
            eng.state = mods["mdgnn"].init_state(cfg, args.device)
        for lo in range(0, args.events, args.block):
            hi = min(lo + args.block, args.events)
            order = ("parent", "change") if pair % 2 == 0 else \
                ("change", "parent")
            for side in order:
                _, eng, stream, _, items = sides[side]
                secs[side].append(run_block(eng, stream, items, lo, hi,
                                            args.tick,
                                            np.random.default_rng(pair)))
            sizes.append(hi - lo)
            pair += 1
        a, b = (sides[k][1].state["memory"].mem for k in secs)
        table_diff.append(float((a - b).abs().max()))
    out = {"modules": {k: v[0]["mdgnn"].__file__ for k, v in sides.items()}}
    for side, s in secs.items():
        rate = np.asarray(sizes) / np.asarray(s)
        q1, med, q3 = np.percentile(rate, [25, 50, 75])
        out[side] = {"events_per_s_median": float(med),
                     "events_per_s_iqr": [float(q1), float(q3)],
                     "block_seconds": s}
    out["pairs"] = pair
    out["table_max_abs_diff"] = table_diff
    out["change_won"] = int(sum(c < p for p, c in zip(secs["parent"],
                                                      secs["change"])))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
