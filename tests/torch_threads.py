"""Torch's intra-op threads for the port's tests, set on import: under
pytest-xdist each of the N workers takes os.cpu_count() // N threads (at
least one), so that the workers' torch thread pools, each as large as the
host by default, do not oversubscribe its cores (six workers of eight
threads each on an eight-core host took two to seven times as long over
the port's files); a run without xdist keeps torch's default.

Every `tests/test_torch_*.py` that imports it sets it for its worker, and
xdist's workers import every test module when they collect, so the whole
run takes it. It changes no test's arithmetic: torch's CPU results do not
depend on the thread count beyond the order of parallel sums, which each
test's tolerance covers, and a bit-for-bit comparison runs both sides in
one process."""
from __future__ import annotations

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
