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
them (`reset_launch_counts` also clears `flash_attn`'s count by route).
A CUDA graph's replay calls no wrapper: its owner takes the counters'
change across the capture (`launch_census`, `launches_since`) and adds
it back at every replay (`add_launches`), so the counts still say how
many times each kernel ran.

`dispatch` is the raw route. The named wrappers below it are what the
models call: `gru_cell`, `memory_update_table`, `embed_attn`,
`pres_predict`, `neighbor_attn`, `pres_filter`, `memory_update` and the
zoo's `flash_attn` and `ssd_chunk` go through `autodiff` (the routed
forward, a backward through the plain version), so training
differentiates through the kernels; `link_score` (serving's top-k only)
is the raw route."""
from __future__ import annotations

import dataclasses
import functools
from types import ModuleType
from typing import Any, Callable

import torch

from repro_torch.kernels import autodiff
from repro_torch.kernels import embed_attn as _ea
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import gru_cell as _gru
from repro_torch.kernels import link_score as _ls
from repro_torch.kernels import memory_update as _mu
from repro_torch.kernels import memory_update_dense as _mud
from repro_torch.kernels import neighbor_attn as _na
from repro_torch.kernels import pres_filter as _pf
from repro_torch.kernels import pres_predict as _pp
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as _ssd

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
    "gru_cell": KernelSpec(
        "gru_cell", _gru.gru_cell_cuda, ref.gru_cell_ref, _gru,
        "src/repro/kernels/gru_cell.py:34"),
    "pres_predict": KernelSpec(
        "pres_predict", _pp.pres_predict_cuda, ref.pres_predict_ref, _pp,
        "src/repro/kernels/memory_update.py:290"),
    "neighbor_attn": KernelSpec(
        "neighbor_attn", _na.neighbor_attn_cuda, ref.neighbor_attn_ref, _na,
        "src/repro/kernels/neighbor_attn.py:38"),
    "pres_filter": KernelSpec(
        "pres_filter", _pf.pres_filter_cuda, ref.pres_filter_ref, _pf,
        "src/repro/kernels/pres_filter.py:37"),
    "memory_update": KernelSpec(
        "memory_update", _mud.memory_update_cuda, ref.memory_update_ref,
        _mud, "src/repro/kernels/memory_update.py:69"),
    "flash_attn": KernelSpec(
        "flash_attn", _fa.flash_attn_cuda, ref.flash_attn_ref, _fa,
        "src/repro/kernels/flash_attn.py:73"),
    "ssd_chunk": KernelSpec(
        "ssd_chunk", _ssd.ssd_chunk_cuda, ref.ssd_chunk_ref, _ssd,
        "src/repro/kernels/ssd_chunk.py:49"),
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


def launch_census() -> dict:
    """Every launch counter: {kernel name: count} and {("flash_attn",
    route): count}."""
    census = launch_counts()
    census.update({("flash_attn", route): n
                   for route, n in _fa.launches_by_route.items()})
    return census


def launches_since(before: dict) -> dict:
    """The counters that changed since the census `before`, by how much."""
    return {key: n - before.get(key, 0)
            for key, n in launch_census().items() if n != before.get(key, 0)}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add `times` x `delta` (a `launches_since` result) to the counters."""
    for key, n in delta.items():
        if isinstance(key, tuple):
            _fa.launches_by_route[key[1]] += n * times
        else:
            REGISTRY[key].module.launches += n * times


def reset_launch_counts() -> None:
    for spec in REGISTRY.values():
        spec.module.launches = 0
    for route in _fa.launches_by_route:
        _fa.launches_by_route[route] = 0


# Differentiable kernels (kernels/autodiff.py): the routed forward, a
# backward through the plain version.
#   gru_cell(x, h, w, u, b, *, mode) -> (M, D) new states
#   memory_update_table(table, last_t, x, gather_idx, write_idx, times, w,
#       u, b, delta_mean, scale, gamma, *, mode, clip, delta_mode, h=None)
#       -> (table, last_t, s_meas, fused, delta), in place on table/last_t;
#       gather from the returned table for the gradient to reach this pass;
#       h: the rows at gather_idx before the call, if the caller has them
#   embed_attn(h_self, tab, idx, dt, valid, tw, tb, wq, wk, wv, *, mode,
#       n_heads) -> (R, E); idx and valid take no gradient
#   pres_predict(s_prev, delta_mean, scale, *, mode, clip) -> (M, D)
#   neighbor_attn(q, k, v, valid, *, mode) -> (M, E); valid (bool, or int8
#       turned into bool here: the kernel reads bool bytes) takes none
#   pres_filter(s_prev, s_meas, delta_mean, dt, gamma, *, mode, clip,
#       delta_mode) -> (fused, delta), each (M, D); gamma is 0-d; dt (the
#       Eq. 7 scale, from state) takes no gradient
#   memory_update(x, h, w, u, b, delta_mean, scale, gamma, *, mode, clip,
#       delta_mode) -> (s_meas, fused, delta), each (M, D)
#   flash_attn(q, k, v, *, mode, causal=True, window=None) -> (G, S, D) in
#       q's dtype; q (G, S, D), k and v (Gkv, T, D), G % Gkv == 0
#   ssd_chunk(q, k, v, lcum, h0, *, mode) -> (y (G, L, P), h1 (G, N, P))
gru_cell = autodiff.oracle_vjp(functools.partial(dispatch, "gru_cell"),
                               ref.gru_cell_ref)
memory_update_table = autodiff.table_vjp(
    functools.partial(dispatch, "memory_update_table"), ref.memory_update_ref)
embed_attn = autodiff.oracle_vjp(functools.partial(dispatch, "embed_attn"),
                                 ref.embed_attn_ref, nondiff=(2, 4))
pres_predict = autodiff.oracle_vjp(
    functools.partial(dispatch, "pres_predict"), ref.pres_predict_ref)
_neighbor_attn = autodiff.oracle_vjp(
    functools.partial(dispatch, "neighbor_attn"), ref.neighbor_attn_ref,
    nondiff=(3,))

pres_filter = autodiff.oracle_vjp(
    functools.partial(dispatch, "pres_filter"), ref.pres_filter_ref,
    nondiff=(3,))
memory_update = autodiff.oracle_vjp(
    functools.partial(dispatch, "memory_update"), ref.memory_update_ref)
flash_attn = autodiff.oracle_vjp(
    functools.partial(dispatch, "flash_attn"), ref.flash_attn_ref)
ssd_chunk = autodiff.oracle_vjp(
    functools.partial(dispatch, "ssd_chunk"), ref.ssd_chunk_ref)


def neighbor_attn(q, k, v, valid, **kw):
    if valid.dtype != torch.bool:
        valid = valid != 0
    return _neighbor_attn(q, k, v, valid, **kw)


def link_score(h_src, h_items, w1, b1, w2, b2, **kw):
    return dispatch("link_score", h_src, h_items, w1, b1, w2, b2, **kw)
