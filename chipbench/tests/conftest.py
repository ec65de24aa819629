"""The harness's tests: on the CPU at tiny sizes, and with the `card`
marker those that need a CUDA card (they skip here; on the card run
`python -m pytest -q chipbench/tests`)."""
from __future__ import annotations

import os
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


# under pytest-xdist each of the N workers takes cores // N torch threads,
# as the port's tests do (tests/torch_threads.py): tiny CPU runs with a
# pool as large as the host in every worker take many times as long
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the control's precision, TF32, "
                    "exists only there)")
    return torch.device("cuda", 0)


TINY_CONFIG = dict(n_users=60, n_items=20, n_nodes=80, d_edge=8, d_mem=16,
                   d_msg=16, d_time=8, d_embed=16, epoch_events=600)


def tiny(name: str):
    """A cell of BENCHMARK.json at a size a CPU test can hold: the same
    model (layers, heads, neighbours), narrower and smaller."""
    from chipbench import bench
    cell = bench.load_cell(name)
    cell.config.update(TINY_CONFIG)
    cell.traffic.update(batch=100, profile_steps=3)
    return cell
