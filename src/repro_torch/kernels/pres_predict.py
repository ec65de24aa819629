"""`pres_predict`: the Eq. 7 staleness fill of the pipelined schedule,
`s + clip(scale * dmean, -clip, clip)` over the (N, D) memory snapshot, as
a hand-written CUDA kernel (`csrc/pres_predict.cu`).

Replaces `repro/kernels/memory_update.py::_pres_predict_pallas`; the source
note in `csrc/pres_predict.cu` says what bounds it on the card.

`ops.pres_predict` takes the plain version (`ref.pres_predict_ref`) for
tensors on the CPU and launches this kernel for CUDA tensors. `launches`
counts kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def pres_predict_cuda(s_prev, delta_mean, scale, *, clip: float = 5.0):
    """Launch the CUDA kernel; returns the (M, D) float32 filled rows."""
    global launches
    dev = s_prev.device
    if dev.type != "cuda":
        raise ValueError(f"pres_predict kernel needs CUDA tensors, got {dev}")
    m, d = s_prev.shape
    f32 = torch.float32
    _build.check_args("pres_predict", dev, [
        ("s_prev", s_prev, f32, (m, d)),
        ("delta_mean", delta_mean, f32, (m, d)), ("scale", scale, f32, (m,))])
    out = torch.empty((m, d), dtype=f32, device=dev)
    err = _build.library().repro_pres_predict(
        s_prev.data_ptr(), delta_mean.data_ptr(), scale.data_ptr(), m, d,
        float(clip), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "pres_predict")
    launches += 1
    return out
