"""The cell kernels' summed bound (forward, recompute and backward launches) over their summed device time in the profiled train steps."""

from portbench.lib import readers


def read(rec):
    return readers.cell_roofline(rec, "train")
