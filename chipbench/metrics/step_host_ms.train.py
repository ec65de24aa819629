"""Host milliseconds of a `train_step` call as `run_epoch` makes it (the
median over the window; the harness times the call, with no sync)."""
from chipbench import readers


def read(rec):
    return readers.host_percentile(rec, "train_step", 50)
