"""`flash_attn`: causal or windowed GQA attention with an online softmax,
as two hand-written CUDA kernels chosen by the inputs' dtype. It is the
attention of the zoo's long prefills (`nn/attention.py::
blockwise_attention`).

- bfloat16: `csrc/flash_attn_wgmma.cu` (route "wgmma"): bf16 tensor-core
  products (`wgmma`) on K/V tiles that TMA brings into shared memory, P
  split into two bf16 parts so that P V keeps fp32-grade accuracy.
- float32: `csrc/flash_attn.cu` (route "fma"): one block a (group, 64-row
  query tile) on the fp32 FMA units.

This is a dispatch between two kernels, not a fallback: a launch that
fails raises. Both replace `repro/kernels/flash_attn.py::
_flash_attn_pallas`; their source notes say what bounds them on the card.

`ops.flash_attn` takes the plain version (`ref.flash_attn_ref`) for
tensors on the CPU and launches a kernel for CUDA tensors. `launches`
counts kernel launches, `launches_by_route` the same by route."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_D = 256       # head width limit of both kernels
ROUTES = {torch.float32: "fma", torch.bfloat16: "wgmma"}

launches = 0
launches_by_route = {"fma": 0, "wgmma": 0}


def _tma_ready(x, d8):
    """x zero-padded to d8 columns (TMA's row stride is a multiple of 16
    bytes) and copied if its start is not 16-byte aligned."""
    if x.shape[-1] != d8:
        x = F.pad(x, (0, d8 - x.shape[-1]))
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def flash_attn_cuda(q, k, v, causal=True, window=None):
    """Launch the kernel of q's dtype; returns (G, S, D) in that dtype.

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
    if q.dtype not in ROUTES:
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
    route = ROUTES[q.dtype]
    lib = _build.library()
    win = 0 if window is None else int(window)
    if route == "wgmma":
        d8 = -(-d // 8) * 8
        qp, kp, vp = (_tma_ready(x, d8) for x in (q, k, v))
        out = torch.empty((g, s, d8), dtype=q.dtype, device=dev)
        err = lib.repro_flash_attn_wgmma(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), g, gkv, s, t, d8,
            int(causal), win, math.sqrt(d), out.data_ptr(),
            _build.stream_ptr(dev))
        if d8 != d:
            out = out[..., :d].contiguous()
    else:
        out = torch.empty_like(q)
        err = lib.repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g, gkv, s, t, d,
            int(causal), win, math.sqrt(d), out.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(err, f"flash_attn ({route})")
    launches += 1
    launches_by_route[route] += 1
    return out
