"""Does a torch.profiler session lose kernel records after CUDA graph
replays, or after a session that traced them?

    python3 tools/torch_profiler_sessions.py [--sessions 12]

On the card: `chip_smoke.device_ms` (one try a session, 5 calls of a
1000 x 100 `torch.add`) `--sessions` times in a fresh process, then after
100 replays of a two-kernel CUDA graph outside any session, then after a
`chip_smoke._profile_windows` session of eager adds, then after one that
traced 50 replays of the graph, then 2 s later. Prints, for each stage,
how many sessions recorded every kernel of their calls (`device_ms` not
None). `chip_smoke.py` traces every CUDA graph replay it profiles in the
process's first session; this checks whether later sessions need that."""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("torch_profiler_sessions: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    x = torch.randn(1000, 100, device=dev)
    add = lambda: torch.add(x, x)

    def sessions(stage):
        got = [cs.device_ms(add, reps=5, tries=1)
               for _ in range(args.sessions)]
        complete = sum(v is not None for v in got)
        print(f"{stage}: {complete}/{args.sessions} sessions complete",
              flush=True)

    sessions("fresh process")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x * 2 + 1
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x * 2 + 1
    for _ in range(100):
        graph.replay()
    torch.cuda.synchronize(dev)
    sessions("after graph replays outside any session")
    cs._profile_windows([("eager", lambda: [add() for _ in range(50)],
                          "50 adds")])
    sessions("after a session of eager ops only")
    cs._profile_windows([("graph", lambda: [graph.replay()
                                            for _ in range(50)],
                          "50 replays")])
    sessions("after a session that traced graph replays")
    time.sleep(2)
    sessions("2 s later")
    return 0


if __name__ == "__main__":
    sys.exit(main())
