"""`memory_update_table` share of its roofline over the profiled
training steps (its symbols are part of this yardstick)."""
from chipbench import readers

KERNELS = ("memory_update_rows_kernel", "memory_update_scatter_kernel")


def read(rec):
    return readers.roofline(rec, "memory_update_table", KERNELS)
