"""Telemetry (counterpart of `repro/obs/`), with one contract:
instrumentation never adds a per-step host sync.

* `obs.metrics` - the per-step obs vector packed on the device inside the
  step and fetched once per epoch, fixed log-spaced latency histograms and
  the PRES GMM tracker-health probe.
* `obs.trace`   - stages as `torch.profiler.record_function` ranges, host
  wall-clock spans for the stages around the device (prefetch waits,
  store windows, checkpoint IO), and a bounded `torch.profiler` capture.
* `obs.sink`    - the JSONL run-log (one schema for train and serve, the
  JAX package's), its manifest and `canonical`.

The JAX package's `tools/inspect_run.py` renders a run-log of either."""
from repro_torch.obs import metrics, sink, trace

__all__ = ["metrics", "sink", "trace"]
