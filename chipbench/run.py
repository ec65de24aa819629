"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`):

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of `BENCHMARK.json` on the card it is started on and prints
one JSON line: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and last the
compared numbers beside their limits. It needs CUDA and as many cards as
the cell asks for, and imports the port only: it exits with another code
than 0 if a JAX module or the JAX package is loaded once the window has
closed.

`--calibrate SEEDS` (comma-separated) prints, per seed, the numbers that
decide `correct` for the program and for the control (the reference in
the precision below the configuration's), with no window: what the limits
were set from (PERF.md)."""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", default=None)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from chipbench import bench

    bench_json = bench.load_json(ROOT / "BENCHMARK.json")
    cell = bench.load_cell(args.workload, bench_json)
    chips = next(w["chips"] for w in bench_json["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    driver = importlib.import_module(f"chipbench.drivers.{cell.kind}")
    if args.calibrate:
        for seed in (int(s) for s in args.calibrate.split(",")):
            print(json.dumps(driver.calibrate(cell, seed, device)),
                  flush=True)
        return 0
    result, checks = driver.run(cell, args.seed, args.seconds,
                                bool(args.trace), device)
    bad = bench.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
