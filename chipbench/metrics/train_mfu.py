"""The training step's share of the chip's peak: the window's steps' FLOPs
at their logical sizes (work/train_step.py: forward times three) over the
window's wall time, against the dense TF32 peak."""
from chipbench import bench


def read(rec):
    sizes = rec.get("step_sizes")
    if not sizes or rec["window_s"] <= 0:
        return None
    flops = sum(bench.work("train_step", s)[0] for s in sizes)
    return 100.0 * flops / rec["window_s"] / rec["peaks"]["flops_per_s"]
