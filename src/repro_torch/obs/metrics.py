"""Device-accumulated training and serving metrics (counterpart of
`repro/obs/metrics.py`).

The zero-sync contract: every per-step signal is packed into ONE device
vector inside the step (`pack_train_obs`, riding the step's metrics dict),
kept on the device across the epoch, and fetched once per epoch
(`EpochObs.finish`: one copy of every payload together). With telemetry
on, the step loop adds no host round trip; `host_fetches()` counts the
flushes so tests can pin the contract. The vector is built with fill
kernels, never from a host scalar copied over, so it can sit inside a
captured CUDA graph (`train/scan.py`).

Also here: fixed log-spaced latency histograms (the serve replay reports
whole distributions) and the PRES GMM tracker-health probe."""
from __future__ import annotations

import numpy as np
import torch

# One slot per signal; engines that lack a signal write 0. The order is
# the on-wire schema - append only, never reorder (the sink stamps
# `obs_fields` into the manifest).
TRAIN_OBS_FIELDS = (
    "loss",              # step training loss (BCE + beta * coherence)
    "coherence_cos",     # Eq. 10 memory-coherence cosine (1 - penalty)
    "pres_delta_mean",   # mean ||M_meas - M_pred|| over written rows (Eq. 7)
    "pres_delta_max",    # max row norm of the same prediction error
    "pres_delta_events", # written rows the delta stats average over
    "staleness",         # pipeline snapshot staleness ticks (0 = sequential)
    "events",            # valid events predicted this step
)

_FIELD_INDEX = {f: i for i, f in enumerate(TRAIN_OBS_FIELDS)}


def pack_train_obs(**values) -> torch.Tensor:
    """Pack named per-step scalars into the fixed (F,) float32 obs vector,
    on the device of the first tensor among them (the CPU if none is).
    Unnamed fields are 0; an unknown name raises KeyError."""
    for k in values:
        if k not in _FIELD_INDEX:
            raise KeyError(f"unknown obs field {k!r}; schema: "
                           f"{TRAIN_OBS_FIELDS}")
    dev = next((v.device for v in values.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))

    def slot(f):
        v = values.get(f, 0.0)
        if isinstance(v, torch.Tensor):
            return v.detach().to(torch.float32).reshape(())
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    return torch.stack([slot(f) for f in TRAIN_OBS_FIELDS])


def unpack_series(stacked) -> dict:
    """(S, F) host array of per-step obs vectors -> {field: (S,) floats},
    lists that drop straight into the JSONL sink."""
    stacked = np.asarray(stacked, np.float64).reshape(
        -1, len(TRAIN_OBS_FIELDS))
    return {f: [float(x) for x in stacked[:, i]]
            for i, f in enumerate(_FIELD_INDEX)}


def pres_delta_stats(s_pred, s_meas, written):
    """PRES prediction-error stats over the written memory rows: the row
    norms ||M_meas - M_pred|| masked to `written`. Returns (mean, max,
    count) device scalars; an all-masked step gives zeros."""
    m = written.to(torch.float32)
    err = torch.linalg.vector_norm(
        (s_meas.float() - s_pred.float()) * m[:, None], dim=-1)
    cnt = torch.sum(m)
    mean = torch.sum(err) / torch.clamp(cnt, min=1.0)
    return mean, torch.max(err), cnt


# ---------------------------------------------------------------------------
# Per-epoch device-side accumulation (shared by the three engines)
# ---------------------------------------------------------------------------

_host_fetches = 0


def host_fetches() -> int:
    """Process-lifetime count of flush fetches (test probe)."""
    return _host_fetches


def _fetch(tensors: list) -> list:
    """One device-to-host copy of a list of tensors (float64 on the host),
    counted once."""
    global _host_fetches
    _host_fetches += 1
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


class EpochObs:
    """Per-epoch telemetry accumulator shared by the lag-one, pipelined and
    scan engines.

    `step(metrics)` pops the obs payload and the per-shard overflow
    counts out of a step's metrics dict and keeps them, and the step's
    route-overflow count, on the device: no host sync in the step loop.
    `finish()` does the epoch's one fetch and returns
    `(route_overflow_total, obs)`, where the total is 0 for an unsharded
    run and `obs` is None unless a step emitted obs vectors or per-shard
    counts, else {"series": {field: [floats]}, "steps": int} and, on
    sharded runs with cfg.obs_metrics, "route_overflow_shards" (the
    epoch's (n_shards,) totals by sending shard). A payload is (F,) /
    () / (n_shards,) from a step or (T, F) / (T,) / (T, n_shards) from a
    scan macro-batch."""

    def __init__(self):
        self._obs = []          # (F,) or (T, F) device tensors
        self._ovf = []          # () or (T,) device overflow counts
        self._shards = []       # (n_shards,) or (T, n_shards) device counts

    def step(self, metrics: dict) -> None:
        if "route_overflow" in metrics:
            self._ovf.append(metrics["route_overflow"])
        o = metrics.pop("obs", None)
        if o is not None:
            self._obs.append(o)
        s = metrics.pop("route_overflow_shards", None)
        if s is not None:
            self._shards.append(s)

    def finish(self) -> tuple[int, dict | None]:
        parts = self._ovf + self._obs + self._shards
        if not parts:
            return 0, None
        got = _fetch(parts)
        n_ovf, n_obs = len(self._ovf), len(self._obs)
        ovf, obs, shards = (got[:n_ovf], got[n_ovf:n_ovf + n_obs],
                            got[n_ovf + n_obs:])
        total = int(sum(int(np.sum(x)) for x in ovf))
        if not (obs or shards):
            return total, None
        out: dict = {}
        if obs:
            rows = np.concatenate([np.atleast_2d(x) for x in obs])
            out["series"] = unpack_series(rows)
            out["steps"] = int(rows.shape[0])
        if shards:
            per = sum(x.reshape(-1, x.shape[-1]).sum(axis=0) for x in shards)
            out["route_overflow_shards"] = [int(x) for x in per]
        return total, out


# ---------------------------------------------------------------------------
# Fixed log-spaced latency histograms
# ---------------------------------------------------------------------------


def log_bucket_edges(lo: float, hi: float, n: int) -> np.ndarray:
    """n log-spaced bucket edges over [lo, hi] -> (n+1,) float64, strictly
    increasing. Fixed edges, so histograms of different runs merge bucket
    by bucket."""
    if not (lo > 0 and hi > lo and n >= 1):
        raise ValueError(f"need 0 < lo < hi and n >= 1, got {lo}, {hi}, {n}")
    return np.geomspace(lo, hi, n + 1)


# the serving-latency bucket table: 0.01 ms .. 10 s, 8 buckets a decade
LATENCY_EDGES_MS = log_bucket_edges(1e-2, 1e4, 48)


def latency_hist(seconds, edges_ms: np.ndarray = LATENCY_EDGES_MS) -> dict:
    """Bucket wall-clock durations (seconds) into the fixed millisecond
    buckets; under- and overflow clamp into the end buckets, so the counts
    sum to len(seconds)."""
    ms = np.asarray(seconds, np.float64) * 1e3
    ms = np.clip(ms, edges_ms[0], np.nextafter(edges_ms[-1], 0))
    counts, _ = np.histogram(ms, bins=edges_ms)
    return {"edges_ms": [float(e) for e in edges_ms],
            "counts": [int(c) for c in counts],
            "n": int(ms.size)}


def hist_percentile(hist: dict, q: float) -> float:
    """Upper-edge percentile estimate (ms) from a `latency_hist` dict: the
    upper edge of the bucket holding the q-th sample; 0.0 when empty."""
    counts = np.asarray(hist["counts"], np.int64)
    total = counts.sum()
    if total == 0:
        return 0.0
    target = np.ceil(q / 100.0 * total)
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, target))
    return float(hist["edges_ms"][idx + 1])


# ---------------------------------------------------------------------------
# GMM tracker health (PRES variance trackers, Eq. 9)
# ---------------------------------------------------------------------------


def gmm_health(pres_state) -> dict:
    """Tracker-health probe over the real tracker rows (the dump row left
    out): the share of rows observed, the observation count, and the
    mean |mu|, mean and max variance over the observed rows. One device
    computation and one fetch: call it between epochs, never in a step."""
    from repro_torch.core import pres
    rows = pres_state.rows()
    _, mu, var = pres.gmm(rows.n, rows.xi, rows.psi)
    per_node = torch.sum(rows.n, dim=1)
    tracked = per_node > 0
    denom = torch.clamp(torch.sum(tracked), min=1).to(torch.float32)
    w = tracked.to(torch.float32)[:, None, None]
    keys = ("tracked_fraction", "observations", "mean_abs_mu", "mean_var",
            "max_var")
    vals = _fetch([
        torch.mean(tracked.to(torch.float32)),
        torch.sum(per_node),
        torch.sum(torch.abs(mu) * w) / (denom * mu.shape[1] * mu.shape[2]),
        torch.sum(var * w) / (denom * var.shape[1] * var.shape[2]),
        torch.max(var)])
    return {k: float(v) for k, v in zip(keys, vals)}
