"""The dense `memory_update`: the GRU cell, then the PRES Eq. 7-9 filter
(`csrc/pres_rows.cuh`), over M rows given as they are, returning
(s_meas, fused, delta). Replaces
`repro/kernels/memory_update.py::_memory_update_pallas`. Its kernel is
`memory_update_table`'s phase 1 without the gather (`csrc/memory_update.cu`,
entry `repro_memory_update`). As in the JAX package, only the registry op
`ops.memory_update` calls it.

`ops` takes the plain version (`ref.memory_update_ref`) for tensors on the
CPU and launches this kernel for CUDA tensors; there is no fallback between
the two. `h` may be float32 or bfloat16 (a bf16 memory table's rows,
widened to fp32 in the kernel as JAX's kernel casts them on load); every
other input and each output is float32. `launches` counts kernel
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def memory_update_cuda(x, h, w, u, b, delta_mean, scale, gamma, *,
                       clip: float = 5.0, delta_mode: str = "innovation"):
    """Launch the dense CUDA kernel; returns (s_meas, fused, delta), each
    (M, D) float32."""
    global launches
    if delta_mode not in ("innovation", "transition"):
        raise ValueError(f"unknown delta_mode {delta_mode!r}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"memory_update kernel needs CUDA tensors, got {dev}")
    m, din = x.shape
    d = h.shape[-1]
    f32 = torch.float32
    h_dtype = h.dtype if h.dtype == torch.bfloat16 else f32
    gamma = gamma.reshape(1)
    _build.check_args("memory_update", dev, [
        ("x", x, f32, (m, din)), ("h", h, h_dtype, (m, d)),
        ("w", w, f32, (din, 3 * d)), ("u", u, f32, (d, 3 * d)),
        ("b", b, f32, (3 * d,)), ("delta_mean", delta_mean, f32, (m, d)),
        ("scale", scale, f32, (m,)), ("gamma", gamma, f32, (1,))])
    s_meas = torch.empty((m, d), dtype=f32, device=dev)
    fused = torch.empty_like(s_meas)
    delta = torch.empty_like(s_meas)
    args = (x.data_ptr(), din, h.data_ptr(), d, w.data_ptr(), u.data_ptr(),
            b.data_ptr(), delta_mean.data_ptr(), scale.data_ptr(),
            gamma.data_ptr(), float(clip), int(delta_mode == "innovation"), m,
            s_meas.data_ptr(), fused.data_ptr(), delta.data_ptr())
    lib = _build.library()
    if h_dtype == torch.bfloat16:
        scratch = torch.empty((m, d), dtype=f32, device=dev)
        err = lib.repro_memory_update_bf16(*args, scratch.data_ptr(),
                                           _build.stream_ptr(dev))
    else:
        err = lib.repro_memory_update(*args, _build.stream_ptr(dev))
    _build.check(err, "memory_update")
    launches += 1
    return s_meas, fused, delta
