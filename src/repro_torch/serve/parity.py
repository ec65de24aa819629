"""The offline-parity gate (counterpart of `repro/serve/parity.py`).

Serving is evaluation restructured, so a ServeEngine driven ingest(prev)
then query(pos) / query(neg) over a stream must give the scores of
`loop.make_eval_step`'s fold-then-score pass, with the same lag-one order
and the same negatives, to float tolerance (the JAX gate asks 1e-5). On
the card the engine it drives is the captured one, so the gate also holds
the CUDA graphs to the eager evaluator."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.events import EventStream
from repro_torch.graph.negatives import sample_negatives
from repro_torch.models import mdgnn
from repro_torch.models.mdgnn import MDGNNConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop


def check_offline_parity(cfg: MDGNNConfig, params, state,
                         stream: EventStream, dst_range, *,
                         batch_size: int = 64, seed: int = 7,
                         batcher: MicroBatcher | None = None, device=None):
    """Run the engine and the offline evaluator over `stream` in lock step.

    Returns (max_diff, n_scored, engine): the largest |engine - eval_step|
    score gap over every valid positive and negative pair, how many pairs
    were compared, and the driven engine (its `trace_counts` show one
    preparation per key). Both sides run on copies of `state`, which is
    left as it was; the engine freezes the PRES trackers
    (`track_deltas=False`), as the evaluator does. Negatives come from a
    torch.Generator seeded with `seed` on the device. `params` and `state`
    live on `device` (cuda unless "cpu" is given)."""
    dev = resolve_device(device)
    eval_step = loop.make_eval_step(cfg)
    st = mdgnn.clone_state(state)
    eng = ServeEngine(cfg, params, mdgnn.clone_state(state),
                      track_deltas=False,
                      batcher=batcher or MicroBatcher(d_edge=cfg.d_edge),
                      item_range=dst_range, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    host = lambda b: {k: getattr(b, k).cpu().numpy()
                      for k in ("src", "dst", "t", "feat", "mask")}
    it = stream.iter_temporal_batches(batch_size, dev)
    prev = next(it)
    max_diff, n_scored = 0.0, 0
    for batch in it:
        neg = sample_negatives(gen, batch, *dst_range)
        st, lp, ln = eval_step(params, st, prev, batch, neg)
        p, b, n = host(prev), host(batch), host(neg)
        m = p["mask"]
        eng.ingest(p["src"][m], p["dst"][m], p["t"][m], p["feat"][m])
        pm, nm = b["mask"], n["mask"]
        sp = eng.query(b["src"][pm], b["dst"][pm], b["t"][pm])
        sn = eng.query(n["src"][nm], n["dst"][nm], n["t"][nm])
        max_diff = max(max_diff,
                       float(np.abs(sp - lp.cpu().numpy()[pm]).max()),
                       float(np.abs(sn - ln.cpu().numpy()[nm]).max()))
        n_scored += int(pm.sum() + nm.sum())
        prev = batch
    return max_diff, n_scored, eng
