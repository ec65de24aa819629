"""`neighbor_attn`: masked single-head attention of each row over its K
slots (the heads folded into the rows by the caller), as a hand-written
CUDA kernel (`csrc/neighbor_attn.cu`, one warp a row). It is the attention
of the dense TGN embedding (`dedup_embed=False`) and of APAN's mailbox.

Replaces `repro/kernels/neighbor_attn.py::_neighbor_attn_pallas`; the
source note in `csrc/neighbor_attn.cu` says what bounds it on the card.

`ops.neighbor_attn` takes the plain version (`ref.neighbor_attn_ref`) for
tensors on the CPU and launches this kernel for CUDA tensors. `launches`
counts kernel launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_SLOTS = 128    # K limit of the kernel (NA_MAX_K in the source)
MAX_E = 256        # folded row width limit of the kernel

launches = 0


def neighbor_attn_cuda(q, k, v, valid):
    """Launch the CUDA kernel; returns (M, E) float32.

    `valid` is a bool tensor: the kernel reads its bytes as 0 / 1
    (`ops.neighbor_attn` turns an int8 mask into bool before it gets
    here)."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"neighbor_attn kernel needs CUDA tensors, got {dev}")
    m, e = q.shape
    kk = k.shape[1] if k.dim() == 3 else -1
    if not 1 <= kk <= MAX_SLOTS or not 1 <= e <= MAX_E:
        raise ValueError(f"neighbor_attn kernel supports 1 <= K <= "
                         f"{MAX_SLOTS} and 1 <= E <= {MAX_E}; got k of shape "
                         f"{tuple(k.shape)}")
    f32 = torch.float32
    _build.check_args("neighbor_attn", dev, [
        ("q", q, f32, (m, e)), ("k", k, f32, (m, kk, e)),
        ("v", v, f32, (m, kk, e)), ("valid", valid, torch.bool, (m, kk))])
    out = torch.empty((m, e), dtype=f32, device=dev)
    err = _build.library().repro_neighbor_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), m, kk, e,
        math.sqrt(e), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "neighbor_attn")
    launches += 1
    return out
