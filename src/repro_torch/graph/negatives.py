"""Negative event sampling (counterpart of `repro/graph/negatives.py`):
for each positive batch, corrupt destinations uniformly over the
destination-node range (the standard MDGNN protocol).

The distribution is the JAX package's: a uniform batch index picks each
negative's source, time and mask, its destination is uniform in
[dst_lo, dst_hi), and its features are zeros. The draws come from an
explicit `torch.Generator`; they are not `jax.random`'s bits, so parity
tests hand the JAX draws to `loop.run_epoch` / `loop.evaluate` /
`scan.ScanEngine.run_epoch` instead."""
from __future__ import annotations

import torch

from repro_torch.graph.events import EventBatch


def _draw(generator, batch, dst_lo, dst_hi, num, gdev):
    n = num or batch.src.shape[0]
    size = batch.src.shape[0]
    idx = torch.randint(0, size, (n,), generator=generator,
                        device=gdev).to(batch.src.device)
    neg_dst = torch.randint(dst_lo, dst_hi, (n,), generator=generator,
                            device=gdev).to(batch.src.device)
    return EventBatch(src=batch.src[idx], dst=neg_dst, t=batch.t[idx],
                      feat=torch.zeros((n, batch.feat.shape[1]),
                                       dtype=batch.feat.dtype,
                                       device=batch.feat.device),
                      mask=batch.mask[idx])


def sample_negatives_in(generator: torch.Generator, batch: EventBatch,
                        dst_lo: int, dst_hi: int,
                        num: int | None = None) -> EventBatch:
    """In-step sampling: `generator` lives on the batch's device, so the
    draw is device work only (no copy, no host sync) and a CUDA graph of
    the step records it (train/scan.py). Two draws a batch, in the host
    loop's order, so a scan epoch draws the lag-one loop's negatives."""
    dev = batch.src.device
    if torch.device(generator.device) != dev:
        raise ValueError(f"sample_negatives_in needs the generator on the "
                         f"batch's device {dev}, got {generator.device}")
    return _draw(generator, batch, dst_lo, dst_hi, num, dev)


def sample_negatives(generator: torch.Generator, batch: EventBatch,
                     dst_lo: int, dst_hi: int,
                     num: int | None = None) -> EventBatch:
    """The host loop's entry point: the draws of `sample_negatives_in`,
    with the generator on any device (drawn there, then moved to the
    batch's)."""
    return _draw(generator, batch, dst_lo, dst_hi, num,
                 torch.device(generator.device))
