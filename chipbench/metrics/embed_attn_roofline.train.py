"""`embed_attn` share of its roofline over the profiled training steps
(the forward kernel; the backward is plain PyTorch)."""
from chipbench import readers

KERNELS = ("embed_attn_kernel",)


def read(rec):
    return readers.roofline(rec, "embed_attn", KERNELS)
