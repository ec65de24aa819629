"""One-shot converter of event sources into an on-disk event store
(counterpart of the JAX package's `tools/convert_events.py`, same flags
and the same bytes).

Three mutually exclusive sources:

  --csv PATH          a JODIE-format CSV (user,item,timestamp,label,f0,...)
  --dataset NAME      an in-RAM synthetic preset (graph/datasets.py SPECS)
  --synthetic NAME    a streaming power-law preset (STREAM_SPECS), written
                      chunk by chunk with bounded memory; --n-events cuts
                      it to its first events (the node space is kept)

The store is written once to --out and memory-mapped after
(`graph.store.EventStore.open`); --csr also builds the chunked CSR
neighbour index at <out>/csr:

    PYTHONPATH=src python -m repro_torch.launch.convert_events \\
        --synthetic stream-tiny --out /tmp/stream-tiny --csr
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def convert(args):
    """Write the store (and the index); returns the opened EventStore."""
    from repro_torch.graph import csr as csr_lib
    from repro_torch.graph import datasets
    from repro_torch.graph import events as events_lib
    from repro_torch.graph import store as store_lib

    t0 = time.perf_counter()
    if args.synthetic:
        spec = datasets.STREAM_SPECS[args.synthetic]
        store = datasets.write_stream_spec(spec, args.out, seed=args.seed,
                                           chunk_events=args.chunk_events,
                                           n_events=args.n_events)
    else:
        if args.csv:
            stream = events_lib.load_jodie_csv(args.csv)
            n_users = int(stream.src.max()) + 1
            meta = {"source": "jodie_csv", "csv": args.csv,
                    "n_users": n_users,
                    "n_items": stream.num_nodes - n_users}
        else:
            stream = datasets.get_dataset(args.dataset, seed=args.seed)
            spec = datasets.SPECS[args.dataset]
            meta = {"source": "synthetic", "dataset": args.dataset,
                    "seed": args.seed, "n_users": spec.n_users,
                    "n_items": spec.n_items}
        store = store_lib.write_stream(stream, args.out,
                                       chunk_events=args.chunk_events,
                                       meta=meta)
    dt = time.perf_counter() - t0
    rate = store.n_events / max(dt, 1e-9)
    print(f"wrote {store.path}: {store.n_events:,} events, "
          f"{store.num_nodes:,} nodes, feat_dim {store.feat_dim}, "
          f"{store.nbytes / 1e6:.1f} MB in {dt:.2f}s "
          f"({rate / 1e6:.2f}M events/s)")
    if args.csr:
        t0 = time.perf_counter()
        index = csr_lib.build_csr(store, path=store.path / "csr",
                                  chunk_events=args.chunk_events)
        nbytes = sum(np.asarray(a).nbytes for a in
                     (index.indptr, index.nbr, index.ts, index.eid))
        print(f"wrote {index.path}: nnz {index.nnz:,}, "
              f"{nbytes / 1e6:.1f} MB in {time.perf_counter() - t0:.2f}s")
    return store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--csv", help="JODIE-format CSV to convert")
    src.add_argument("--dataset", help="in-RAM synthetic preset (SPECS name)")
    src.add_argument("--synthetic",
                     help="streaming power-law preset (STREAM_SPECS name)")
    ap.add_argument("--out", required=True, help="store directory to create")
    ap.add_argument("--chunk-events", type=int, default=1 << 20,
                    help="events per write chunk (the bytes do not depend "
                         "on it; it bounds memory)")
    ap.add_argument("--seed", type=int, default=0,
                    help="generator seed (synthetic sources)")
    ap.add_argument("--n-events", type=int, default=None,
                    help="--synthetic: only the first N events")
    ap.add_argument("--csr", action="store_true",
                    help="also build the CSR neighbour index at <out>/csr")
    convert(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
