"""Host milliseconds of StreamingEngine.step's own work (staging, fan-out) an engine step: its span less SODa.predict's."""

from portbench.lib import readers


def read(rec):
    return readers.span_ms(rec, "serve", "engine_step", less="predict")
