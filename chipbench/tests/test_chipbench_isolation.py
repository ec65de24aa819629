"""The harness runs the port alone: in a fresh process (the test
workers load JAX for other tests) a tiny run of the driver leaves no
module of JAX or of the JAX package `repro` loaded (top-level names
compared whole: `repro_torch` begins with `repro`), and nothing under
`benchmarks/`; the command refuses to run without CUDA, and in a
checkout that holds only the benchmark's files, printing no result."""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

CODE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from chipbench import bench
from chipbench.drivers import train
from chipbench.tests.conftest import tiny
train.run(tiny("train-tgl-std-b600"), 5, 0.1, True, "cpu")
loaded = sorted(sys.modules)
print("PORT", "repro_torch" in loaded)
print("FORBIDDEN", bench.forbidden_modules())
print("BENCHMARKS", [m for m in loaded if m.split(".")[0] == "benchmarks"])
"""


def test_no_jax_and_no_jax_package_in_a_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(root=str(ROOT),
                                           src=str(ROOT / "src"))],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(l.split(" ", 1) for l in out.stdout.splitlines()
                 if l.split(" ", 1)[0] in ("PORT", "FORBIDDEN", "BENCHMARKS"))
    assert lines == {"PORT": "True", "FORBIDDEN": "[]", "BENCHMARKS": "[]"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from chipbench import bench
    for name in ("repro_torch.x", "reproduce", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"repro_torch.x", "reproduce", "jaxtyping", "flaxen"} & set(
        bench.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.graph", sys)
    assert "repro.graph" in bench.forbidden_modules()


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "train-tgl-pres-b2400", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def test_no_result_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
