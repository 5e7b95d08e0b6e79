"""The forward convs' least time at the fp32 peak over the device time of the kernels the aten convolution ops launched in the profiled eval steps."""

from portbench.lib import readers


def read(rec):
    return readers.conv_roofline(rec, "eval")
