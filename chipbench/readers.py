"""What the per-layer readers (`metrics/<name>.py`) share. A reader takes
the run's record and returns its number, or None where the record holds
nothing to read: then the metric is left out of the line. A share of a
roofline is never made up as 0.

The record: "host_s" {call: [seconds]} (the harness's host timers),
"window_s", "step_sizes" (each window step's logical sizes), "calls"
[(op, sizes)] (each profiled call), "dev" and "host" (the profiler's device events and host ranges),
"spans" (the profiled window), "trace" (its reduction) and "peaks"."""
from __future__ import annotations

from chipbench import bench


def host_percentile(rec: dict, call: str, q: float):
    xs = rec.get("host_s", {}).get(call)
    return bench.percentile(xs, q) * 1e3 if xs else None


def roofline(rec: dict, op: str, kernels: tuple):
    """The least time the profiled calls of `op` could take on the chip
    (each call's FLOPs at the peak rate or its bytes at the peak
    bandwidth, the larger), as a share of the device time of the op's
    kernels: those whose symbol holds one of `kernels`, started inside
    the profiled window."""
    if "dev" not in rec:
        return None
    calls = [s for o, s in rec["calls"] if o == op]
    device_s = bench.kernel_seconds(rec["dev"], kernels, rec["spans"])
    if not calls or device_s <= 0:
        return None
    pk = rec["peaks"]
    bound = 0.0
    for s in calls:
        flops, nbytes = bench.work(op, s)
        bound += max(flops / pk["flops_per_s"], nbytes / pk["bytes_per_s"])
    return 100.0 * bound / device_s


def idle_share(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
