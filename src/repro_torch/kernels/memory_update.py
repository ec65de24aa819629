"""`memory_update_table`: the fused memory-maintenance pass of one ingest
(GRU gates, PRES Eq. 7 predict, Eq. 8 correct, Eq. 9 delta rate, and the
table scatter), as a hand-written CUDA kernel (`csrc/memory_update.cu`).

Replaces `repro/kernels/memory_update.py::_memory_update_table_pallas`.
The source note in `csrc/memory_update.cu` says what bounds it on the card
and why it runs in two phases (gather-and-compute, then scatter) instead of
the TPU kernel's in-order aliased walk.

`ops.memory_update_table` takes the plain version
(`ref.memory_update_table_ref`) for tensors on the CPU and launches this
kernel for CUDA tensors; there is no fallback between the two. `launches`
counts kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def memory_update_table_cuda(table, last_t, x, gather_idx, write_idx, times,
                             w, u, b, delta_mean, scale, gamma, *,
                             clip: float = 5.0,
                             delta_mode: str = "innovation"):
    """Launch the CUDA kernel. Updates `table` (N, D) and `last_t` (N,) IN
    PLACE and returns (table, last_t, s_meas, fused, delta)."""
    global launches
    if delta_mode not in ("innovation", "transition"):
        raise ValueError(f"unknown delta_mode {delta_mode!r}")
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"memory_update_table kernel needs CUDA tensors, "
                         f"got {dev}")
    n, d = table.shape
    m, din = x.shape
    f32, i32 = torch.float32, torch.int32
    gamma = gamma.reshape(1)
    _build.check_args("memory_update_table", dev, [
        ("table", table, f32, (n, d)), ("last_t", last_t, f32, (n,)),
        ("x", x, f32, (m, din)), ("gather_idx", gather_idx, i32, (m,)),
        ("write_idx", write_idx, i32, (m,)), ("times", times, f32, (m,)),
        ("w", w, f32, (din, 3 * d)), ("u", u, f32, (d, 3 * d)),
        ("b", b, f32, (3 * d,)), ("delta_mean", delta_mean, f32, (m, d)),
        ("scale", scale, f32, (m,)), ("gamma", gamma, f32, (1,))])
    s_meas = torch.empty((m, d), dtype=f32, device=dev)
    fused = torch.empty_like(s_meas)
    delta = torch.empty_like(s_meas)
    err = _build.library().repro_memory_update_table(
        table.data_ptr(), last_t.data_ptr(), n, d, x.data_ptr(), din,
        gather_idx.data_ptr(), write_idx.data_ptr(), times.data_ptr(),
        w.data_ptr(), u.data_ptr(), b.data_ptr(), delta_mean.data_ptr(),
        scale.data_ptr(), gamma.data_ptr(), float(clip),
        int(delta_mode == "innovation"), m, s_meas.data_ptr(),
        fused.data_ptr(), delta.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "memory_update_table")
    launches += 1
    return table, last_t, s_meas, fused, delta

