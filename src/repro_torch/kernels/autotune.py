"""Measure-once-then-cache autotuner for the kernel registry (counterpart
of `repro/kernels/autotune.py`).

`ops.dispatch` resolves an execution mode per call. When neither the
caller nor `REPRO_KERNELS_MODE` pins one, it consults this module's cache:
per (backend, kernel, shape signature) the measured-fastest candidate.
`python -m repro_torch.kernels.autotune` sweeps the shapes the model emits
(one train step of each kernel's route at `tgn_pres.CONFIG` widths, a
top-k, reduced qwen3 and xlstm prefills) and persists the winners.

Cache file: results/autotune/torch-<backend>.json, with JAX's layout and
keys (JAX's file is results/autotune/<backend>.json, whose entries name
Pallas modes; this module never reads it):

    {
      "backend": "cuda",
      "torch": "2.6.0",
      "entries": {
        "gru_cell|float32[1000,100];float32[1000,100];...": {
          "mode": "compiled", "blocks": {}, "ms": 0.021,
          "oracle_ms": 0.28, "swept": 1
        }
      }
    }

Departures from JAX, because the plain version must not reach the card's
main path unseen:

* the launchers fix their tiles, so the block grid is empty ({});
* on "cuda" the default candidates are "compiled" alone, and the entry
  records the plain version's time beside it as `oracle_ms` (JAX's
  entries carry `ceiling_ms`); on "cpu" the only candidate is "oracle"
  (there is no interpreter);
* `record` refuses an "oracle" winner for "cuda", and `ops.dispatch`
  refuses a cache entry naming "oracle" for a CUDA tensor. The plain
  version runs on the card only where the caller pins it (`mode=`,
  `cfg.kernels_mode` or the environment variable).

The timer is injectable (tests pick a deterministic winner with a fake
timer); the default is wall clock to a device sync, best of `repeats`
after one untimed call."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import sys
import time
from typing import Callable, Sequence

import numpy as np
import torch

CACHE_DIR = (pathlib.Path(__file__).resolve().parents[3]
             / "results" / "autotune")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def shape_sig(args: Sequence) -> str:
    """Canonical dtype[shape] signature of a positional argument list, as
    JAX's (`float32[2,3];int32[5];bool[4];float`) for tensors and numpy
    arrays alike."""
    parts = []
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            dims = ",".join(str(int(s)) for s in a.shape)
            parts.append(f"{_dtype_name(a.dtype)}[{dims}]")
        else:
            parts.append(type(a).__name__)
    return ";".join(parts)


def cache_path(backend: str) -> pathlib.Path:
    return CACHE_DIR / f"torch-{backend}.json"


@functools.lru_cache(maxsize=None)
def _file_entries(backend: str) -> dict:
    """Entries read once per process (`clear_cache` drops the memo)."""
    p = cache_path(backend)
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text()).get("entries", {})
    except (json.JSONDecodeError, OSError):
        return {}


def clear_cache() -> None:
    _file_entries.cache_clear()


def n_entries(backend: str) -> int:
    return len(_file_entries(backend))


def lookup(backend: str, name: str, args: Sequence) -> dict | None:
    """Cached selection for this kernel at this shape, or None."""
    return _file_entries(backend).get(f"{name}|{shape_sig(args)}")


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _sync(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            torch.cuda.synchronize(a.device)
            return


def wall_timer(fn: Callable, args: Sequence, cand: dict,
               repeats: int = 3) -> float:
    """One untimed call, then the best of `repeats` wall-clock ms, each to
    a device sync. `cand` is unused here; fake timers read it."""
    del cand
    fn(*args)
    _sync(args)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def candidates(name: str, backend: str,
               modes: Sequence[str] | None = None) -> list[dict]:
    """The sweep: "compiled" on cuda, "oracle" on cpu, unless `modes`
    says otherwise; every candidate has empty blocks."""
    from repro_torch.kernels import ops
    ops.get_kernel(name)
    if modes is None:
        modes = ("compiled",) if backend == "cuda" else ("oracle",)
    out = []
    for mode in modes:
        ops._check_mode(mode)
        out.append({"mode": mode, "blocks": {}})
    return out


def tune(name: str, args: Sequence, *, backend: str | None = None,
         timer: Callable = wall_timer, modes: Sequence[str] | None = None,
         extra_kw: dict | None = None) -> dict:
    """Measure every candidate at these args and return the winning entry
    {"mode", "blocks", "ms", "swept"}, on cuda with "oracle_ms" (the plain
    version, timed beside it, never a candidate unless `modes` names it).
    Candidates that raise are skipped; if all do, RuntimeError."""
    from repro_torch.kernels import ops
    backend = backend or ops.backend()
    extra = dict(extra_kw or {})
    best, swept = None, 0
    for cand in candidates(name, backend, modes):
        fn = functools.partial(ops.dispatch, name, mode=cand["mode"],
                               **extra)
        try:
            ms = float(timer(fn, args, cand))
        except Exception:     # noqa: BLE001 - a failing candidate is skipped
            continue
        swept += 1
        if best is None or ms < best["ms"]:
            best = {"mode": cand["mode"], "blocks": {}, "ms": ms}
    if best is None:
        raise RuntimeError(f"autotune: no candidate for kernel {name!r} "
                           f"succeeded at sig {shape_sig(args)}")
    best["swept"] = swept
    if backend == "cuda":
        plain = functools.partial(ops.dispatch, name, mode="oracle", **extra)
        best["oracle_ms"] = float(timer(plain, args,
                                        {"mode": "oracle", "blocks": {}}))
    return best


def record(backend: str, name: str, args: Sequence, entry: dict) -> None:
    """Merge one winning entry into the backend's cache file and drop the
    in-process memo so the next dispatch sees it. Refuses an "oracle"
    winner for cuda."""
    if backend == "cuda" and entry.get("mode") == "oracle":
        raise ValueError(
            f"autotune: refusing to cache the plain version for {name} on "
            f"cuda; it would run on the card's main path unseen")
    p = cache_path(backend)
    p.parent.mkdir(parents=True, exist_ok=True)
    data = {"backend": backend, "torch": torch.__version__, "entries": {}}
    if p.exists():
        try:
            data = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            pass
    data["backend"] = backend
    data["torch"] = torch.__version__
    data.setdefault("entries", {})[f"{name}|{shape_sig(args)}"] = entry
    p.write_text(json.dumps(data, indent=2, sort_keys=True))
    clear_cache()


def autotune(name: str, args: Sequence, *, backend: str | None = None,
             timer: Callable = wall_timer, modes: Sequence[str] | None = None,
             extra_kw: dict | None = None, force: bool = False) -> dict:
    """Measure-once-then-cache: the cached selection for this (kernel,
    shape) if there is one, else tune, persist and return it."""
    from repro_torch.kernels import ops
    backend = backend or ops.backend()
    if not force:
        hit = lookup(backend, name, args)
        if hit is not None:
            return hit
    entry = tune(name, args, backend=backend, timer=timer, modes=modes,
                 extra_kw=extra_kw)
    record(backend, name, args, entry)
    return entry


# ---------------------------------------------------------------------------
# The shapes the model emits
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def record_calls():
    """Record the first (args, static kwargs) of every (kernel, shape
    signature) dispatched while entered, cloned, into the yielded dict
    {(name, sig): (args, kw)}; both routes go through unchanged."""
    from repro_torch.kernels import ops
    saved = dict(ops.REGISTRY)
    seen: dict = {}

    def wrap(name, fn):
        def run(*args, **kw):
            key = (name, shape_sig(args))
            if key not in seen:
                seen[key] = ([a.detach().clone() for a in args], dict(kw))
            return fn(*args, **kw)
        return run

    for name, spec in saved.items():
        ops.REGISTRY[name] = dataclasses.replace(
            spec, cuda=wrap(name, spec.cuda), ref=wrap(name, spec.ref))
    try:
        yield seen
    finally:
        ops.REGISTRY.update(saved)


def emitted_shapes(device, d_mem: int | None = None, batch_size: int = 500,
                   seed: int = 0) -> dict:
    """{(name, sig): (args, kw)} of every registered kernel at the shapes
    the model emits: one lag-one train step of each kernel's route at
    `tgn_pres.CONFIG` widths (`d_mem` overrides d) on wiki-small (PRES:
    memory_update_table, embed_attn; Alg. 1: gru_cell; pipelined:
    pres_predict; dense TGN: neighbor_attn; the rnn cell: pres_filter), a
    top-k over wiki-small's items (link_score), the dense memory_update on
    the table kernel's occurrences, and prefills of reduced qwen3
    (flash_attn) and xlstm (ssd_chunk)."""
    from repro_torch.archs.api import get_model
    from repro_torch.configs import get_config, tgn_pres
    from repro_torch.graph import datasets
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import autodiff
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine
    from repro_torch.train import pipeline

    dev = torch.device(device)
    spec = datasets.SPECS["wiki-small"]
    stream = datasets.get_dataset("wiki-small", seed)
    dst = (spec.n_users, spec.n_users + spec.n_items)
    cfg = dataclasses.replace(tgn_pres.CONFIG, n_nodes=stream.num_nodes,
                              d_edge=stream.feat_dim, use_kernels=True)
    if d_mem is not None:
        cfg = dataclasses.replace(cfg, d_mem=d_mem, d_msg=d_mem,
                                  d_embed=d_mem)
    batches = stream.slice(0, 3 * batch_size).temporal_batches(batch_size,
                                                               dev)
    gen = torch.Generator(dev).manual_seed(seed)
    routes = [{}, {"use_pres": False}, {"pipeline_depth": 1},
              {"dedup_embed": False}, {"memory_cell": "rnn"}]
    with record_calls() as seen:
        for change in routes:
            c = dataclasses.replace(cfg, **change)
            opt = adamw(1e-3)
            params = mdgnn.init_params(c, torch.Generator().manual_seed(seed),
                                       dev)
            state = mdgnn.init_state(c, dev)
            step = pipeline.make_train_step(c, opt)
            carry = (params, opt.init(params), state)
            if c.pipeline_depth:
                carry += (pipeline.PipelineState.init(state["memory"]),)
            for i in range(2):
                neg = sample_negatives(gen, batches[i + 1], *dst)
                carry = step(*carry, batches[i], batches[i + 1], neg)[:-1]
        params = mdgnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                   dev)
        eng = ServeEngine(cfg, params, mdgnn.init_state(cfg, dev),
                          item_range=dst, device=dev, capture=False)
        eng.recommend_topk(stream.src[:16], stream.t[:16], 10)
        for arch in ("qwen3-0.6b", "xlstm-350m"):
            # attn_chunk 64 at S 256: the blockwise branch (flash_attn)
            zcfg = dataclasses.replace(
                get_config(arch).reduced(attn_chunk=64), dtype=torch.float32)
            model = get_model(zcfg)
            zgen = torch.Generator(dev).manual_seed(seed)
            zp = model.init(zgen, dev)
            tokens = torch.randint(0, zcfg.vocab, (2, 256), generator=zgen,
                                   device=dev)
            with torch.no_grad():
                model.prefill(zp, {"tokens": tokens})
    table = next(v for (n, _), v in seen.items()
                 if n == "memory_update_table")
    (tab, _, x, gidx, _, _, w, u, b, dm, scale, gamma), kw = table
    dense = [x, autodiff.gather_rows(tab, gidx), w, u, b, dm, scale, gamma]
    seen.setdefault(("memory_update", shape_sig(dense)), (dense, dict(kw)))
    return seen


def sweep(device, *, d_mem: int | None = None, force: bool = False,
          timer: Callable = wall_timer, shapes: dict | None = None
          ) -> list[dict]:
    """Tune every (kernel, shape) of `shapes` (default `emitted_shapes`)
    into the cache of the device's backend. Returns one row per entry."""
    backend = torch.device(device).type
    if shapes is None:
        shapes = emitted_shapes(device, d_mem)
    rows = []
    for (name, sig), (args, kw) in sorted(shapes.items(),
                                          key=lambda kv: kv[0]):
        entry = autotune(name, args, backend=backend, timer=timer,
                         extra_kw=kw, force=force)
        rows.append({"kernel": name, "sig": sig, **entry})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--d-mem", type=int, default=None,
                    help="memory width (default CONFIG's 100)")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even where an entry exists")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    rows = sweep(dev, d_mem=args.d_mem, force=args.force)
    for r in rows:
        extra = (f" oracle_ms={r['oracle_ms']:.4f}" if "oracle_ms" in r
                 else "")
        print(f"{r['kernel']:20s} {r['mode']:9s} ms={r['ms']:.4f}{extra} "
              f"{r['sig']}")
    print(f"[autotune] {len(rows)} entries -> {cache_path(dev.type)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
