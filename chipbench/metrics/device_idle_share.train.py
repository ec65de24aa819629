"""The share of the profiled window of steady training steps in which
no kernel, copy or fill ran on the card."""
from chipbench import readers


def read(rec):
    return readers.idle_share(rec)
