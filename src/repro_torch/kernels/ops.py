"""Kernel registry, dispatch and execution policy (counterpart of
`repro/kernels/ops.py`).

`dispatch(name, ...)` resolves the execution mode with precedence
per-call `mode=` (callers forward `cfg.kernels_mode`) > the
`REPRO_KERNELS_MODE` environment variable > the autotune cache
(`kernels/autotune.py`, keyed by backend, kernel and shape signature) >
the default for the tensors' device:

    auto       fall through to the next rule; the default is the CUDA
               kernel for CUDA tensors, the plain version for CPU tensors
    compiled   the CUDA kernel (raises on CPU tensors)
    oracle     the plain PyTorch version on any device; this is how
               chip_smoke.py holds a kernel against its plain version
    interpret  raises: a CUDA kernel has no interpreter

The plain version runs on a CUDA tensor only where the caller pins it
(`mode=`, `cfg.kernels_mode` or the environment variable): a cache entry
that names "oracle" for a CUDA tensor raises, and `autotune.record`
refuses to write one. The environment variable, the backend and the
cache file are read once per process; `reset_execution_policy` drops
them and `execution_policy` reports them. `DISPATCH_LOG` counts each
(kernel, resolved mode) at every Python dispatch: a CUDA graph dispatches
once, at capture, as JAX's log counts once a trace; an eager step counts
every call, where JAX counts once per compilation. The keys, not the
counts, are what two runs compare.

Each kernel module keeps an integer launch count, incremented only where
it launches its CUDA kernel; `launch_counts` / `reset_launch_counts` read
and clear them (`reset_launch_counts` also clears `flash_attn`'s count by
route). A CUDA graph's replay calls no wrapper: its owner takes the
counters' change across the capture (`launch_census`, `launches_since`)
and adds it back at every replay (`add_launches`), so the counts still
say how many times each kernel ran.

`dispatch` is the raw route. The named wrappers below it are what the
models call: `gru_cell`, `memory_update_table`, `embed_attn`,
`pres_predict`, `neighbor_attn`, `pres_filter`, `memory_update` and the
zoo's `flash_attn` and `ssd_chunk` go through `autodiff` (the routed
forward, a backward through the plain version), so training
differentiates through the kernels; `link_score` (serving's top-k only)
is the raw route."""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
from types import ModuleType
from typing import Any, Callable

import torch

from repro_torch.kernels import autodiff, autotune
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
from repro_torch.train import annotate

MODES = ("auto", "compiled", "interpret", "oracle")
ENV_VAR = "REPRO_KERNELS_MODE"


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown kernel execution mode {mode!r}; valid "
                         f"modes: {', '.join(MODES)} (per-call mode=, "
                         f"cfg.kernels_mode, or the {ENV_VAR} env var)")


@functools.lru_cache(maxsize=None)
def backend() -> str:
    """"cuda" where a card is visible, else "cpu" (once per process)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@functools.lru_cache(maxsize=None)
def _env_mode() -> str | None:
    """REPRO_KERNELS_MODE, validated and cached; unset or "auto" -> None."""
    raw = os.environ.get(ENV_VAR, "").strip().lower()
    if not raw or raw == "auto":
        return None
    _check_mode(raw)
    return raw


def _device_default(device_type: str) -> str:
    return "compiled" if device_type == "cuda" else "oracle"


def reset_execution_policy() -> None:
    """Drop every per-process policy memo (backend, env mode, autotune
    file), for tests that flip the env var or swap the cache."""
    backend.cache_clear()
    _env_mode.cache_clear()
    autotune.clear_cache()


def execution_policy() -> dict:
    """The resolved execution policy, for logs and run manifests."""
    return {
        "backend": backend(),
        "env_mode": _env_mode(),
        "default_mode": _env_mode() or _device_default(backend()),
        "autotune_entries": autotune.n_entries(backend()),
        "autotune_cache": str(autotune.cache_path(backend())),
    }


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


def resolve_mode(mode: str | None, device, name: str | None = None,
                 args=()) -> str:
    """The concrete mode ("compiled" or "oracle") for kernel `name` on
    `args`, tensors on `device`: per-call > env var > autotune cache >
    the device's default."""
    if mode is not None and mode != "auto":
        _check_mode(mode)
    else:
        mode = _env_mode()
    device = torch.device(device)
    if (mode is None and name is not None
            and autotune.n_entries(device.type)):
        sel = autotune.lookup(device.type, name, args)
        if sel is not None:
            mode = sel.get("mode")
            _check_mode(mode)
            if mode == "oracle" and device.type == "cuda":
                raise ValueError(
                    f"the autotune cache names the plain version for "
                    f"{name} on CUDA tensors "
                    f"({autotune.cache_path(device.type)}); the plain "
                    f"version runs on the card only when the caller pins "
                    f"it (mode=, cfg.kernels_mode or {ENV_VAR})")
    if mode is None or mode == "auto":
        mode = _device_default(device.type)
    if mode == "interpret":
        raise NotImplementedError(
            "kernels_mode='interpret' runs Pallas bodies op by op; the CUDA "
            "kernels have no interpreter (use 'oracle' for the plain version)")
    return mode


# (kernel, resolved mode) -> dispatch count since process start or the last
# reset_dispatch_log; the obs sink stamps it into every run-log epilogue
DISPATCH_LOG: collections.Counter = collections.Counter()


def dispatch_log() -> dict:
    """{kernel: {mode: dispatch_count}}."""
    out: dict = {}
    for (name, mode), cnt in sorted(DISPATCH_LOG.items()):
        out.setdefault(name, {})[mode] = cnt
    return out


def reset_dispatch_log() -> None:
    DISPATCH_LOG.clear()


def dispatch(name: str, *args, mode: str | None = None, **kw):
    """Run kernel `name` on `args` in the resolved mode (the device is that
    of the first argument)."""
    spec = get_kernel(name)
    mode = resolve_mode(mode, args[0].device, name, args)
    DISPATCH_LOG[(name, mode)] += 1
    if mode == "oracle":
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
#
# On DTensors (the distributed spec's step, train/distributed.py) each
# wrapper runs on local tensors (`annotate.local`): a kernel called through
# ctypes takes plain tensors. On plain tensors `_on_local` adds nothing.
# (The zoo's callers, nn/attention.py and nn/ssm.py, enter `local` first,
# with their batch and head shards.)
def _on_local(f, writes=()):
    @functools.wraps(f)
    def g(*args, **kw):
        return annotate.local(f, *args, writes=writes, **kw)
    return g


gru_cell = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "gru_cell"), ref.gru_cell_ref))
# table and last_t (written in place) are written back to their shards
memory_update_table = _on_local(autodiff.table_vjp(
    functools.partial(dispatch, "memory_update_table"),
    ref.memory_update_ref), writes=(0, 1))
embed_attn = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "embed_attn"), ref.embed_attn_ref,
    nondiff=(2, 4)))
pres_predict = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "pres_predict"), ref.pres_predict_ref))
_neighbor_attn = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "neighbor_attn"), ref.neighbor_attn_ref,
    nondiff=(3,)))

pres_filter = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "pres_filter"), ref.pres_filter_ref,
    nondiff=(3,)))
memory_update = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "memory_update"), ref.memory_update_ref))
flash_attn = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "flash_attn"), ref.flash_attn_ref))
ssd_chunk = _on_local(autodiff.oracle_vjp(
    functools.partial(dispatch, "ssd_chunk"), ref.ssd_chunk_ref))


def neighbor_attn(q, k, v, valid, **kw):
    if valid.dtype != torch.bool:
        valid = valid != 0
    return _neighbor_attn(q, k, v, valid, **kw)


def link_score(h_src, h_items, w1, b1, w2, b2, **kw):
    return annotate.local(dispatch, "link_score", h_src, h_items, w1, b1,
                          w2, b2, **kw)
