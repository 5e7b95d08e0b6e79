"""The share of the profiled train steps' time in which no device op ran."""

from portbench.lib import readers


def read(rec):
    return readers.device_idle(rec, "train")
