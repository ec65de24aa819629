"""`gru_cell`: the GRU memory cell over M rows, as a hand-written CUDA
kernel (`csrc/gru_cell.cu`: both products on the tensor cores at fp32
grade through `csrc/tf32x3.cuh`, the gates formed from the accumulators).

Replaces `repro/kernels/gru_cell.py::_gru_cell_pallas`; the source note in
`csrc/gru_cell.cu` says what bounds it on the card. It is the memory cell
of standard (Alg. 1) training and evaluation (`mdgnn.memory_update`).

`ops.gru_cell` takes the plain version (`ref.gru_cell_ref`) for tensors on
the CPU and launches this kernel for CUDA tensors. `launches` counts
kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def gru_cell_cuda(x, h, w, u, b):
    """Launch the CUDA kernel; returns the (M, D) float32 new states."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gru_cell kernel needs CUDA tensors, got {dev}")
    m, din = x.shape
    d = h.shape[-1]
    f32 = torch.float32
    _build.check_args("gru_cell", dev, [
        ("x", x, f32, (m, din)), ("h", h, f32, (m, d)),
        ("w", w, f32, (din, 3 * d)), ("u", u, f32, (d, 3 * d)),
        ("b", b, f32, (3 * d,))])
    out = torch.empty((m, d), dtype=f32, device=dev)
    err = _build.library().repro_gru_cell(
        x.data_ptr(), din, h.data_ptr(), d, w.data_ptr(), u.data_ptr(),
        b.data_ptr(), m, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "gru_cell")
    launches += 1
    return out
