"""The convs' least time (forward and backward operations at the fp32 peak) over the device time of the kernels the aten convolution ops launched in the profiled train steps."""

from portbench.lib import readers


def read(rec):
    return readers.conv_roofline(rec, "train")
