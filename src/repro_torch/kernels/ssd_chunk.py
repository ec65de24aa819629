"""`ssd_chunk`: one chunk of the chunked linear recurrence (SSD / mLSTM)
for each of G groups, as a hand-written CUDA kernel (`csrc/ssd_chunk.cu`:
all four products on the tensor cores at fp32 grade through
`csrc/tf32x3.cuh`, over blocks of 32 rows of y, walking the key tiles
flash-style, or of the carried state, each on a slab of P columns).
It is the per-chunk math of `nn/ssm.py::chunked_linear_rnn` (the zoo's
mLSTM prefill).

Replaces `repro/kernels/ssd_chunk.py::_ssd_chunk_pallas`; the source note
in `csrc/ssd_chunk.cu` says what bounds it on the card.

`ops.ssd_chunk` takes the plain version (`ref.ssd_chunk_ref`) for tensors
on the CPU and launches this kernel for CUDA tensors. `launches` counts
kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_N = 256       # key width limit (SSD_MAX_N in the source)
MAX_P = 512       # value width limit (SSD_MAX_P in the source)

launches = 0


def ssd_chunk_cuda(q, k, v, lcum, h0):
    """Launch the CUDA kernel; returns (y (G, L, P), h1 (G, N, P)) in
    float32. q, k: (G, L, N); v: (G, L, P); lcum: (G, L); h0: (G, N, P);
    all float32 and contiguous."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors, got {dev}")
    if q.dim() != 3 or v.dim() != 3:
        raise ValueError(f"ssd_chunk: q and v must be 3-d, got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    g, ll, n = q.shape
    p = v.shape[2]
    if not (1 <= n <= MAX_N and 1 <= p <= MAX_P and ll >= 1 and g >= 1):
        raise ValueError(f"ssd_chunk kernel needs 1 <= N <= {MAX_N}, "
                         f"1 <= P <= {MAX_P}, L >= 1; got q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}")
    f32 = torch.float32
    _build.check_args("ssd_chunk", dev, [
        ("q", q, f32, (g, ll, n)), ("k", k, f32, (g, ll, n)),
        ("v", v, f32, (g, ll, p)), ("lcum", lcum, f32, (g, ll)),
        ("h0", h0, f32, (g, n, p))])
    y = torch.empty((g, ll, p), dtype=f32, device=dev)
    h1 = torch.empty((g, n, p), dtype=f32, device=dev)
    err = _build.library().repro_ssd_chunk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lcum.data_ptr(),
        h0.data_ptr(), g, ll, n, p, y.data_ptr(), h1.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "ssd_chunk")
    launches += 1
    return y, h1
