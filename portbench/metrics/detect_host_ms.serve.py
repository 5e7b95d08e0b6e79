"""Host milliseconds of SODa.detect (softmax, decode, NMS) an engine step, over the timed window."""

from portbench.lib import readers


def read(rec):
    return readers.span_ms(rec, "serve", "detect")
