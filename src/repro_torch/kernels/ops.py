"""Kernel registry and dispatch (counterpart of `repro/kernels/ops.py`,
cut down to the kernels ported so far).

`dispatch(name, ..., mode=)` resolves the execution mode with precedence
per-call `mode=` (callers forward `cfg.kernels_mode`) > backend default:

    auto       the CUDA kernel for CUDA tensors, the plain version for CPU
               tensors
    compiled   the CUDA kernel (raises on CPU tensors)
    oracle     the plain PyTorch version on any device; this is how
               chip_smoke.py holds a kernel against its plain version
    interpret  raises: a CUDA kernel has no interpreter

There is no environment variable and no autotune cache yet. Each kernel
module keeps an integer launch count, incremented only where it launches
its CUDA kernel; `launch_counts` / `reset_launch_counts` read and clear
them."""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Any, Callable

from repro_torch.kernels import embed_attn as _ea
from repro_torch.kernels import link_score as _ls
from repro_torch.kernels import memory_update as _mu
from repro_torch.kernels import ref

MODES = ("auto", "compiled", "interpret", "oracle")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ported kernel: its CUDA launcher, its plain version, and the
    module that holds its launch counter."""
    name: str
    cuda: Callable[..., Any]
    ref: Callable[..., Any]
    module: ModuleType
    replaces: str        # the Pallas function it ports


REGISTRY: dict[str, KernelSpec] = {
    "memory_update_table": KernelSpec(
        "memory_update_table", _mu.memory_update_table_cuda,
        ref.memory_update_table_ref, _mu,
        "src/repro/kernels/memory_update.py:179"),
    "embed_attn": KernelSpec(
        "embed_attn", _ea.embed_attn_cuda, ref.embed_attn_ref, _ea,
        "src/repro/kernels/embed_attn.py:79"),
    "link_score": KernelSpec(
        "link_score", _ls.link_score_cuda, ref.link_score_ref, _ls,
        "src/repro/kernels/link_score.py:40"),
}


def get_kernel(name: str) -> KernelSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


def resolve_mode(mode: str | None, device) -> str:
    """The concrete mode ("compiled" or "oracle") for tensors on `device`."""
    mode = mode or "auto"
    if mode not in MODES:
        raise ValueError(f"unknown kernel execution mode {mode!r}; valid "
                         f"modes: {', '.join(MODES)}")
    if mode == "interpret":
        raise NotImplementedError(
            "kernels_mode='interpret' runs Pallas bodies op by op; the CUDA "
            "kernels have no interpreter (use 'oracle' for the plain version)")
    if mode == "auto":
        return "compiled" if device.type == "cuda" else "oracle"
    return mode


def dispatch(name: str, *args, mode: str | None = None, **kw):
    """Run kernel `name` on `args` in the resolved mode (the device is that
    of the first argument)."""
    spec = get_kernel(name)
    if resolve_mode(mode, args[0].device) == "oracle":
        return spec.ref(*args, **kw)
    return spec.cuda(*args, **kw)


def launch_counts() -> dict[str, int]:
    return {name: spec.module.launches for name, spec in REGISTRY.items()}


def reset_launch_counts() -> None:
    for spec in REGISTRY.values():
        spec.module.launches = 0


def memory_update_table(table, last_t, x, gather_idx, write_idx, times,
                        w, u, b, delta_mean, scale, gamma, **kw):
    """Fused touched-row pass, in place on table/last_t. Returns (table,
    last_t, s_meas, fused, delta)."""
    return dispatch("memory_update_table", table, last_t, x, gather_idx,
                    write_idx, times, w, u, b, delta_mean, scale, gamma, **kw)


def embed_attn(h_self, tab, idx, dt, valid, tw, tb, wq, wk, wv, **kw):
    return dispatch("embed_attn", h_self, tab, idx, dt, valid, tw, tb,
                    wq, wk, wv, **kw)


def link_score(h_src, h_items, w1, b1, w2, b2, **kw):
    return dispatch("link_score", h_src, h_items, w1, b1, w2, b2, **kw)
