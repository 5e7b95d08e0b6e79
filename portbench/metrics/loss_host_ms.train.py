"""Host milliseconds of SODa.loss (with the anchor matching) a train step, over the timed window."""

from portbench.lib import readers


def read(rec):
    return readers.span_ms(rec, "train", "loss")
