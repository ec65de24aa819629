"""Named-span stage tracing (counterpart of `repro/obs/trace.py`).

Two kinds of spans, matching the two halves of a step:

* `stage(name)` - a `torch.profiler.record_function` range for the device
  pipeline's stages (`memory_update -> embed -> loss -> apply`, the serve
  engine's `serve_ingest` / `serve_query` / `serve_topk`). The names show
  in `torch.profiler` traces; with no profiler running a range costs a
  few microseconds of host time, so stages are always on.
* `span(name)`  - a host wall-clock span for the stages around the device
  (prefetch waits, event-store windows, checkpoint IO). Recording is gated
  by `enable()`: disabled (the default) a span is a no-op with no timer
  read. Enabled, it also opens a `record_function` range, so host stages
  line up with device work in a captured trace. Safe from any thread.

`StepTraceCapture` wraps a step callable and captures a `torch.profiler`
trace of its first `n_steps` calls (`--trace-dir` / `--trace-steps` in the
launch CLIs), each call inside a `record_function("step#i")` range, and
exports a Chrome trace into the directory."""
from __future__ import annotations

import contextlib
import functools
import pathlib
import threading
import time

import torch

_lock = threading.Lock()
_enabled = False
_spans: list[dict] = []
_t0 = 0.0


def stage(name: str):
    """Profiler range for a device pipeline stage."""
    return torch.profiler.record_function(name)


def enable() -> None:
    """Start recording host spans (timestamps relative to this call)."""
    global _enabled, _t0
    with _lock:
        _spans.clear()
        _t0 = time.perf_counter()
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def drain() -> list[dict]:
    """Return and clear the recorded spans ([{name, t0, dur_s}, ...])."""
    with _lock:
        out, _spans[:] = list(_spans), []
    return out


@contextlib.contextmanager
def span(name: str):
    """Host wall-clock span; a no-op (no timer read) unless `enable()`d."""
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            dur = time.perf_counter() - start
            with _lock:
                if _enabled:
                    _spans.append({"name": name, "t0": start - _t0,
                                   "dur_s": dur})


def span_summary(spans: list[dict]) -> dict:
    """Aggregate drained spans per name: {name: {count, total_s, max_s}}."""
    out: dict = {}
    for s in spans:
        agg = out.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                         "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += s["dur_s"]
        agg["max_s"] = max(agg["max_s"], s["dur_s"])
    return out


class StepTraceCapture:
    """Capture a `torch.profiler` trace of the first `n_steps` calls of a
    wrapped step callable.

        trace = StepTraceCapture("/tmp/trace", n_steps=8)
        step = trace.wrap(step)
        ... run the epoch ...
        trace.stop()               # idempotent; also stops at call n

    The window starts at the first wrapped call and is bounded, so a long
    run captures a slice, not gigabytes. `stop()` synchronises the card
    first, so the window holds the device work of the last call, then
    writes `trace.json` (Chrome trace format) into `trace_dir`."""

    def __init__(self, trace_dir: str, n_steps: int = 8):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.trace_dir = pathlib.Path(trace_dir)
        self.n_steps = n_steps
        self._calls = 0
        self._prof = None

    @property
    def path(self) -> pathlib.Path:
        return self.trace_dir / "trace.json"

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def wrap(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            i = self._calls
            self._calls += 1
            if i == 0:
                self._start()
            if self._prof is None:
                return fn(*args, **kw)
            with torch.profiler.record_function(f"step#{i}"):
                out = fn(*args, **kw)
            if self._calls >= self.n_steps:
                self.stop()
            return out

        return wrapped

    def stop(self) -> None:
        """Stop the capture and write the trace (a no-op if it never
        started or has stopped)."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))
