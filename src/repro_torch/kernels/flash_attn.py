"""`flash_attn`: causal or windowed GQA attention with an online softmax,
as a hand-written CUDA kernel (`csrc/flash_attn.cu`, one block a (group,
64-row query tile), fp32 FMA). It is the attention of the zoo's long
prefills (`nn/attention.py::blockwise_attention`).

Replaces `repro/kernels/flash_attn.py::_flash_attn_pallas`; the source
note in `csrc/flash_attn.cu` says what bounds it on the card.

`ops.flash_attn` takes the plain version (`ref.flash_attn_ref`) for
tensors on the CPU and launches this kernel for CUDA tensors. `launches`
counts kernel launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_D = 256       # head width limit of the kernel (FA_MAX_D in the source)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def flash_attn_cuda(q, k, v, causal=True, window=None):
    """Launch the CUDA kernel; returns (G, S, D) in q's dtype.

    q: (G, S, D); k, v: (Gkv, T, D), all float32 or all bfloat16,
    contiguous, G % Gkv == 0; window None or >= 1."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attn kernel needs CUDA tensors, got {dev}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attn: q and k must be 3-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    g, s, d = q.shape
    gkv, t = k.shape[0], k.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attn kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_D or gkv < 1 or g % gkv or s < 1 or t < 1:
        raise ValueError(f"flash_attn kernel needs 1 <= D <= {MAX_D}, "
                         f"S, T >= 1 and G % Gkv == 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn: window must be >= 1, got {window}")
    _build.check_args("flash_attn", dev, [
        ("q", q, q.dtype, (g, s, d)), ("k", k, q.dtype, (gkv, t, d)),
        ("v", v, q.dtype, (gkv, t, d))])
    out = torch.empty_like(q)
    err = _build.library().repro_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPES[q.dtype], g, gkv, s,
        t, d, int(causal), 0 if window is None else int(window),
        math.sqrt(d), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "flash_attn")
    launches += 1
    return out
