"""The 95th percentile over every camera-frame of the traced run's timed
window of the time from the engine call that handed the frame in to the
return of the call that gave its detections back. The serving cell is
a closed loop at its capacity, where a frame's latency is two step
periods and moves with the rate; its tail is read beside the rate."""


def read(rec):
    if rec is None or rec.get("path") != "serve":
        return None
    return rec["frame_p95_ms"]
