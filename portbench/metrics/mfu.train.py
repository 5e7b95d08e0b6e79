"""The train step's conv operations (forward over every frame, backward over the frames trained from the drawn start) at the fp32 peak, as a share of the profiled steps' time."""

from portbench.lib import readers


def read(rec):
    return readers.mfu(rec, "train")
