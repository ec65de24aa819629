"""`gru_cell` share of its roofline over the profiled Alg. 1 steps."""
from chipbench import readers

KERNELS = ("gru_cell_kernel",)


def read(rec):
    return readers.roofline(rec, "gru_cell", KERNELS)
