"""`pres_filter`: the PRES filter of the unfused memory route (Eq. 7
predict, Eq. 8 correct, Eq. 9 delta rate) over the M touched occurrence
rows, as a hand-written CUDA kernel (`csrc/pres_filter.cu`, its element
body in `csrc/pres_rows.cuh`).

Replaces `repro/kernels/pres_filter.py::_pres_filter_pallas`; the source
note in `csrc/pres_filter.cu` says what bounds it on the card. It runs
after every memory cell that is not the fused GRU pass (the rnn cell:
`train/loop.py::_apply_pres`).

`ops.pres_filter` takes the plain version (`ref.pres_filter_ref`) for
tensors on the CPU and launches this kernel for CUDA tensors. `launches`
counts kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def pres_filter_cuda(s_prev, s_meas, delta_mean, dt, gamma, *,
                     clip: float = 5.0, delta_mode: str = "innovation"):
    """Launch the CUDA kernel; returns (fused, delta), each (M, D)
    float32."""
    global launches
    if delta_mode not in ("innovation", "transition"):
        raise ValueError(f"unknown delta_mode {delta_mode!r}")
    dev = s_prev.device
    if dev.type != "cuda":
        raise ValueError(f"pres_filter kernel needs CUDA tensors, got {dev}")
    m, d = s_prev.shape
    f32 = torch.float32
    gamma = gamma.reshape(1)
    _build.check_args("pres_filter", dev, [
        ("s_prev", s_prev, f32, (m, d)), ("s_meas", s_meas, f32, (m, d)),
        ("delta_mean", delta_mean, f32, (m, d)), ("dt", dt, f32, (m,)),
        ("gamma", gamma, f32, (1,))])
    fused = torch.empty((m, d), dtype=f32, device=dev)
    delta = torch.empty_like(fused)
    err = _build.library().repro_pres_filter(
        s_prev.data_ptr(), s_meas.data_ptr(), delta_mean.data_ptr(),
        dt.data_ptr(), gamma.data_ptr(), m, d, float(clip),
        int(delta_mode == "innovation"), fused.data_ptr(), delta.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "pres_filter")
    launches += 1
    return fused, delta
