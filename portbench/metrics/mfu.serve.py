"""The engine's conv operations (capacity frames a step) at the fp32 peak, as a share of the profiled engine steps' time."""

from portbench.lib import readers


def read(rec):
    return readers.mfu(rec, "serve")
