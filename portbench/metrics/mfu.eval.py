"""The eval step's conv operations (forward over every frame) at the fp32 peak, as a share of the profiled eval steps' time."""

from portbench.lib import readers


def read(rec):
    return readers.mfu(rec, "eval")
