"""`embed_attn`: one deduplicated TGN attention layer (neighbour gather
from the unique table, cosine time encoding, Q/K/V projections, masked
multi-head softmax, weighted sum) as a hand-written CUDA kernel
(`csrc/embed_attn.cu`).

Replaces `repro/kernels/embed_attn.py::_embed_attn_pallas`; the source note
in `csrc/embed_attn.cu` says what bounds it on the card and how it folds
the K/V projections out of the slots (q into Wk per row, the softmax's
weighted sum of the slots' inputs into Wv per row), with the per-row
products on the tensor cores at fp32 grade.

`ops.embed_attn` takes the plain version (`ref.embed_attn_ref`) for tensors
on the CPU and launches this kernel for CUDA tensors. `launches` counts
kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_SLOTS = 64     # K limit of the kernel (EA_MAX_K in the source)
MAX_E = 128        # E limit of the kernel (EA_MAX_E in the source)
MAX_DIN = 256      # table width limit (EA_MAX_DIN): the kv registers a lane
MAX_DTIME = 128    # time-encoding width limit (EA_MAX_DTIME)
MAX_SMEM = 232448  # dynamic shared memory a block may take on the card

launches = 0


def _ld(width):
    """Row stride of a shared A tile (tf32_ld in `csrc/tf32x3.cuh`)."""
    return ((width + 7) & ~7) + 4


def smem_bytes(ds, c, e):
    """Dynamic shared memory of one block (Layout in the source): the
    a / g tiles of two heads over the h_self tile, q, and the weight ring
    of three 32 x 72 stages, for 32 rows."""
    rows = 32
    return 4 * (max(2 * rows * _ld(c), rows * _ld(ds)) + rows * _ld(e)
                + 3 * 32 * 72)


def embed_attn_cuda(h_self, tab, idx, dt, valid, tw, tb, wq, wk, wv, *,
                    n_heads: int = 1):
    """Launch the CUDA kernel; returns (R, E) float32 aggregated heads."""
    global launches
    dev = h_self.device
    if dev.type != "cuda":
        raise ValueError(f"embed_attn kernel needs CUDA tensors, got {dev}")
    r, ds = h_self.shape
    u, din = tab.shape
    kk = idx.shape[1] if idx.dim() == 2 else -1
    dtime = tw.shape[0]
    e = wq.shape[1]
    if not 1 <= kk <= MAX_SLOTS:
        raise ValueError(f"embed_attn kernel supports 1 <= K <= {MAX_SLOTS}, "
                         f"got idx of shape {tuple(idx.shape)}")
    if n_heads < 1 or e % n_heads or e > MAX_E:
        raise ValueError(f"embed_attn kernel needs E <= {MAX_E} and E "
                         f"divisible by n_heads; got E={e}, "
                         f"n_heads={n_heads}")
    if not (1 <= din <= MAX_DIN and dtime <= MAX_DTIME):
        raise ValueError(f"embed_attn kernel supports table widths 1 to "
                         f"{MAX_DIN} and time encodings up to {MAX_DTIME}; "
                         f"got Din={din}, d_time={dtime}")
    if smem_bytes(ds, din + dtime, e) > MAX_SMEM:
        raise ValueError(f"embed_attn kernel: widths ds={ds}, c={din + dtime}"
                         f", E={e} need {smem_bytes(ds, din + dtime, e)} "
                         f"bytes of shared memory a block, over {MAX_SMEM}")
    f32 = torch.float32
    _build.check_args("embed_attn", dev, [
        ("h_self", h_self, f32, (r, ds)), ("tab", tab, f32, (u, din)),
        ("idx", idx, torch.int32, (r, kk)), ("dt", dt, f32, (r, kk)),
        ("valid", valid, torch.bool, (r, kk)), ("tw", tw, f32, (dtime,)),
        ("tb", tb, f32, (dtime,)), ("wq", wq, f32, (ds, e)),
        ("wk", wk, f32, (din + dtime, e)), ("wv", wv, f32, (din + dtime, e))])
    out = torch.empty((r, e), dtype=f32, device=dev)
    err = _build.library().repro_embed_attn(
        h_self.data_ptr(), ds, tab.data_ptr(), din, idx.data_ptr(),
        dt.data_ptr(), valid.data_ptr(), r, kk, tw.data_ptr(), tb.data_ptr(),
        dtime, wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), e, n_heads,
        out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "embed_attn")
    launches += 1
    return out

