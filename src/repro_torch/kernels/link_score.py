"""`link_score`: the (B, I) link-decoder scores of every (source, item)
pair for serving's top-k, as one hand-written CUDA kernel launch
(`csrc/link_score.cu`: per block of items, the item and source factors on
the tensor cores at fp32 grade, kept in shared memory, then the pair pass
on the FMA units; neither factor nor the (B, I, D) hidden values reach
device memory, and the output is the only tensor allocated).

Replaces `repro/kernels/link_score.py::_link_score_pallas`.
`ops.link_score` takes the plain version (`ref.link_score_ref`) for tensors
on the CPU and launches the kernel for CUDA tensors. `launches` counts
calls that launched it (one launch a call)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def link_score_cuda(h_src, h_items, w1, b1, w2, b2):
    """Launch the CUDA kernel; returns (B, I) float32 scores."""
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
    out = torch.empty((nb, ni), dtype=f32, device=dev)
    err = _build.library().repro_link_score(
        h_src.data_ptr(), h_items.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), nb, ni, d, out.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "link_score")
    launches += 1
    return out

