"""The T = 1 cell launches' summed bound over their summed device time in the profiled engine steps."""

from portbench.lib import readers


def read(rec):
    return readers.cell_roofline(rec, "serve")
