"""`link_score`: the (B, I) link-decoder scores of every (source, item)
pair for serving's top-k, as hand-written CUDA kernels
(`csrc/link_score.cu`: the two factor products, then the pair tile pass
whose (B, I, D) hidden values never reach device memory).

Replaces `repro/kernels/link_score.py::_link_score_pallas`.
`ops.link_score` takes the plain version (`ref.link_score_ref`) for tensors
on the CPU and launches these kernels for CUDA tensors. `launches` counts
calls that launched them."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def link_score_cuda(h_src, h_items, w1, b1, w2, b2):
    """Launch the CUDA kernels; returns (B, I) float32 scores."""
    global launches
    dev = h_src.device
    if dev.type != "cuda":
        raise ValueError(f"link_score kernel needs CUDA tensors, got {dev}")
    nb, d = h_src.shape
    ni = h_items.shape[0]
    f32 = torch.float32
    _build.check_args("link_score", dev, [
        ("h_src", h_src, f32, (nb, d)), ("h_items", h_items, f32, (ni, d)),
        ("w1", w1, f32, (2 * d, d)), ("b1", b1, f32, (d,)),
        ("w2", w2, f32, (d, 1)), ("b2", b2, f32, (1,))])
    a = torch.empty((nb, d), dtype=f32, device=dev)
    c = torch.empty((ni, d), dtype=f32, device=dev)
    out = torch.empty((nb, ni), dtype=f32, device=dev)
    err = _build.library().repro_link_score(
        h_src.data_ptr(), h_items.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), nb, ni, d, a.data_ptr(), c.data_ptr(),
        out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "link_score")
    launches += 1
    return out

