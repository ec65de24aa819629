"""What every driver shares: the cell's files found by name, the program's
configuration, the device's description, the check that no JAX module is
loaded, the per-layer readers, the profiler's reduction and the result
line.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its configuration is
`configs/<config>.json`, its traffic mix `workloads/<traffic>.json` (whose
`kind` names its driver, `drivers/<kind>.py`), its limits
`limits/<cell>.json`, each per-layer metric a reader
`metrics/<metric>.py`, and each op's work count `work/<op>.py`."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]

    def applies(metric):
        return name in metric.get("workloads", cells)

    return Cell(name=name,
                config=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "workloads" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def program_config(config: dict, **overrides):
    """The program's MDGNNConfig of a configuration file's fields."""
    from repro_torch.models.mdgnn import MDGNNConfig
    names = {f.name for f in dataclasses.fields(MDGNNConfig)}
    fields = {k: v for k, v in config.items() if k in names}
    fields.update(overrides)
    return MDGNNConfig(**fields)


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "chipbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_WORK: dict = {}


def work(op: str, sizes: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of `op` at its logical sizes."""
    if op not in _WORK:
        _WORK[op] = load_module(HERE / "work" / f"{op}.py")
    return _WORK[op].count(sizes)


def peaks(device_kind: str) -> dict:
    table = load_json(HERE / "peaks.json")
    if device_kind not in table:
        raise SystemExit(f"no peaks for {device_kind!r} in peaks.json")
    return table[device_kind]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def percentile(values, q: float) -> float:
    """The q-th percentile of the samples (linear between ranks)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return statistics.median(values) if values else math.nan


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's or the JAX
    reference package's, compared as whole names."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def read_layer_metrics(cell: Cell, rec: dict) -> dict:
    """Every per-layer metric of the cell that its reader finds something
    for, {name: {"value", "unit"}}."""
    out = {}
    for m in cell.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number
    is a finite reading within its limit."""
    checks = {k: {"value": readings.get(k, math.nan), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines on standard error, and the result as
    the last line on standard output, its checks last."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = dict(result)
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------


def trace_events(prof) -> tuple[list, list]:
    """(device events, host ranges) of a finished torch.profiler session:
    [(name, start_us, end_us)] each, on one clock. Device events are every
    kernel, copy and fill on the card."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if "cuda" in str(e.device_type()).lower():
            dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    # a host range shows on the device's timeline too (a user annotation
    # spanning its kernels): it is no device work
    names = {n for n, _, _ in host}
    return [d for d in dev if d[0] not in names], host


def busy_union(intervals, lo: float, hi: float) -> list:
    """The merged busy intervals of `intervals` clipped to [lo, hi]."""
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in intervals
                   if b > lo and a < hi)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(dev, host, window: tuple) -> dict:
    """Busy and window seconds, the top device ops and the longest idle
    gaps of a traced window, each gap named by the harness's range and
    the innermost host range open at its middle."""
    lo, hi = window
    merged = busy_union(dev, lo, hi)
    busy = sum(b - a for a, b in merged)
    by_name: dict = {}
    for name, a, b in dev:
        if b > lo and a < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo))
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        open_ = [(e - s, n) for n, s, e in host if s <= mid <= e]
        ours = [n for _, n in sorted(open_) if n.startswith("chipbench.")]
        inner = min(open_)[1] if open_ else "none"
        named.append([f"{ours[0] if ours else 'none'}/{inner}",
                      (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "device_ops": [[n, s / 1e6] for n, s in ops],
            "idle_gaps": named}


def kernel_seconds(dev, names, spans) -> float:
    """Device seconds of the kernels whose symbol holds one of `names`
    and that start inside one of `spans` [(start_us, end_us)]."""
    total = 0.0
    for name, a, b in dev:
        if any(n in name for n in names) and any(s <= a <= e
                                                  for s, e in spans):
            total += b - a
    return total / 1e6


def ranges(host, name: str) -> list:
    return [(s, e) for n, s, e in host if n == name]
