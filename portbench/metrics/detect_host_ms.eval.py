"""Host milliseconds of SODa.detect (softmax, decode over every anchor, NMS) an eval step, over the timed window."""

from portbench.lib import readers


def read(rec):
    return readers.span_ms(rec, "eval", "detect")
