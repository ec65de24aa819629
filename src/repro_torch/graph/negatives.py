"""Negative event sampling (counterpart of `repro/graph/negatives.py`):
for each positive batch, corrupt destinations uniformly over the
destination-node range (the standard MDGNN protocol).

The distribution is the JAX package's: a uniform batch index picks each
negative's source, time and mask, its destination is uniform in
[dst_lo, dst_hi), and its features are zeros. The draws come from an
explicit `torch.Generator`; they are not `jax.random`'s bits, so parity
tests hand the JAX draws to `loop.run_epoch` / `loop.evaluate` instead."""
from __future__ import annotations

import torch

from repro_torch.graph.events import EventBatch


def sample_negatives(generator: torch.Generator, batch: EventBatch,
                     dst_lo: int, dst_hi: int,
                     num: int | None = None) -> EventBatch:
    """Draw on the generator's device, then move to the batch's."""
    n = num or batch.src.shape[0]
    size = batch.src.shape[0]
    gdev = generator.device
    idx = torch.randint(0, size, (n,), generator=generator,
                        device=gdev).to(batch.src.device)
    neg_dst = torch.randint(dst_lo, dst_hi, (n,), generator=generator,
                            device=gdev).to(batch.src.device)
    return EventBatch(src=batch.src[idx], dst=neg_dst, t=batch.t[idx],
                      feat=torch.zeros((n, batch.feat.shape[1]),
                                       dtype=batch.feat.dtype,
                                       device=batch.feat.device),
                      mask=batch.mask[idx])
