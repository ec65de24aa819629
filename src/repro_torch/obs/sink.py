"""JSONL run-log sink and run manifests (counterpart of
`repro/obs/sink.py`; the same schema, so the JAX package's
`tools/inspect_run.py` renders the port's run-logs).

A run-log is a JSONL file whose first record is the run manifest (`kind:
"manifest"`: provenance, config, the obs-field schema), then per-epoch or
per-replay records, then a closing block the sink writes itself (host
spans, the kernel-dispatch table of `kernels/ops.py`, an `end` marker).
`canonical()` strips the wall-clock fields so two runs of the same seed
compare equal."""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

SCHEMA_VERSION = 1

# fields whose values depend on wall clock or load, stripped by canonical()
NONDET_KEYS = frozenset({
    "t_start", "t_end", "seconds", "dur_s", "t0", "events_per_sec",
    "queries_per_sec", "epoch_seconds", "compile_seconds", "sim_rate",
    "ingest_ms", "query_ms", "wall_s",
})

# record kinds wholly made of timing (dropped by canonical())
_NONDET_KINDS = frozenset({"spans", "end"})


@functools.lru_cache(maxsize=1)
def git_commit() -> str | None:
    """The checkout's commit (None outside a repository or without git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=pathlib.Path(__file__).resolve().parent)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


@functools.lru_cache(maxsize=1)
def gpu_card() -> str | None:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (its
    first line), or None without a card or nvidia-smi."""
    import torch
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def cfg_digest(cfg) -> str:
    """Short stable digest of a config (dataclass or dict): sha256 over the
    sorted-key JSON of its fields, as JAX's (equal configs, equal
    digests, across the two packages)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_metadata(cfg=None) -> dict:
    """Provenance stamped into every run-log manifest: the torch and CUDA
    versions, the resolved kernel policy, the device count, the git
    commit and the config digest; on the card also its name and power
    limit (`gpu`)."""
    import torch
    from repro_torch.kernels import ops as kops
    pol = kops.execution_policy()
    meta = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": pol["backend"],
        "kernels_default_mode": pol["default_mode"],
        "kernels_env_mode": pol["env_mode"],
        "autotune_entries": pol["autotune_entries"],
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 1),
        "cpu_count": os.cpu_count(),
        "git_commit": git_commit(),
    }
    card = gpu_card()
    if card is not None:
        meta["gpu"] = card
    if cfg is not None:
        meta["cfg_digest"] = cfg_digest(cfg)
    return meta


class RunLog:
    """Append-only JSONL run-log with a leading manifest record.

    The sink takes host values only (the engines' one fetch an epoch), so a
    record costs a json.dumps and a line append, off the step path.
    `close()` appends the epilogue: the recorded host spans (obs.trace),
    the kernel-dispatch table (which mode each kernel dispatched in) and an
    `end` marker."""

    def __init__(self, path, *, role: str, cfg=None, argv=None,
                 extra: dict | None = None):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w")
        self._closed = False
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "role": role,
            "meta": run_metadata(cfg),
            "argv": list(argv if argv is not None else sys.argv[1:]),
            "obs_fields": _obs_fields(),
            "t_start": time.time(),
        }
        if cfg is not None:
            c = (dataclasses.asdict(cfg)
                 if dataclasses.is_dataclass(cfg) else dict(cfg))
            manifest["cfg"] = {k: _jsonable(v) for k, v in c.items()}
        if extra:
            manifest.update(extra)
        self.write("manifest", **manifest)

    def write(self, kind: str, **payload) -> None:
        if self._closed:
            raise ValueError(f"run-log {self.path} is closed")
        rec = {"kind": kind, **{k: _jsonable(v) for k, v in payload.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        from repro_torch.kernels import ops as kops
        from repro_torch.obs import trace as obs_trace
        spans = obs_trace.drain()
        if spans:
            self.write("spans", summary=obs_trace.span_summary(spans),
                       spans=spans)
        table = kops.dispatch_log()
        if table:
            self.write("kernel_dispatch", table=table)
        self.write("end", t_end=time.time())
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _obs_fields():
    from repro_torch.obs import metrics as obs_metrics
    return list(obs_metrics.TRAIN_OBS_FIELDS)


def _jsonable(v):
    """Host-side JSON coercion of numpy scalars and arrays, tensors and
    nested trees of them."""
    import numpy as np
    import torch
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.Tensor):
        return _jsonable(v.detach().cpu().numpy())
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return v.item()
    return v


def read_runlog(path) -> list[dict]:
    """Parse a run-log; ValueError on a malformed file or a missing or
    foreign manifest."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSONL ({e})") from None
    if not records or records[0].get("kind") != "manifest":
        raise ValueError(f"{path}: first record must be a run manifest")
    if records[0].get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema_version {records[0].get('schema_version')!r} "
            f"(this reader speaks {SCHEMA_VERSION})")
    return records


def canonical(records: list[dict]) -> list[dict]:
    """Strip the wall-clock fields (NONDET_KEYS, span and end records) so
    two runs of the same seeded computation compare equal."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k not in NONDET_KEYS}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v

    return [strip(r) for r in records
            if r.get("kind") not in _NONDET_KINDS]
