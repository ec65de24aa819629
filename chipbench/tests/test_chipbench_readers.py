"""The trace reduction and the readers on a hand-made trace: busy time
as a union, gaps named by the harness's range and the innermost host
range, a roofline share from the calls' work and their kernels' time,
and nothing read where nothing was traced."""
from __future__ import annotations

import pytest

from chipbench import bench, readers

# device: two overlapping kernels in one step, one in the next; host:
# the harness's ranges, an op inside the first step's
DEV = [("memory_update_rows_kernel<4>", 10.0, 30.0), ("gather", 20.0, 45.0),
       ("embed_attn_kernel<2, true>", 60.0, 70.0)]
HOST = [("chipbench.window", 0.0, 100.0), ("chipbench.train_step", 5.0, 58.0),
        ("chipbench.run_epoch", 59.0, 95.0), ("aten::copy_", 46.0, 57.0)]


def test_reduce_trace():
    tr = bench.reduce_trace(DEV, HOST, (0.0, 100.0))
    assert tr["busy_s"] == pytest.approx(45e-6)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["device_ops"][0] == ["gather", pytest.approx(25e-6)]
    # gaps: [0, 10), [45, 60), [70, 100), longest first
    assert [round(s * 1e6) for _, s in tr["idle_gaps"]] == [30, 15, 10]
    assert [n for n, _ in tr["idle_gaps"]] == [
        "chipbench.run_epoch/chipbench.run_epoch",
        "chipbench.train_step/aten::copy_",
        "chipbench.train_step/chipbench.train_step"]


def test_roofline_and_idle():
    rec = {"dev": DEV, "host": HOST, "spans": [(0.0, 100.0)],
           "peaks": {"flops_per_s": 1e12, "bytes_per_s": 1e11},
           "calls": [("embed_attn",
                      {"rows": 2, "valid_slots": 3, "child_rows": 4,
                       "ds": 2, "din": 2, "dtime": 1, "e": 2, "heads": 2,
                       "k": 2})],
           "trace": bench.reduce_trace(DEV, HOST, (0.0, 100.0))}
    f, b = bench.work("embed_attn", rec["calls"][0][1])
    want = 100 * max(f / 1e12, b / 1e11) / 10e-6
    got = readers.roofline(rec, "embed_attn", ("embed_attn_kernel",))
    assert got == pytest.approx(want)
    # no profiled call of the op: nothing to read
    assert readers.roofline(rec, "gru_cell", ("gru_cell_kernel",)) is None
    assert readers.idle_share(rec) == pytest.approx(55.0)
    assert readers.roofline({"calls": []}, "embed_attn", ("x",)) is None
    assert readers.idle_share({}) is None
