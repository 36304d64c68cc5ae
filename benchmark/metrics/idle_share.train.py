"""The device's idle share in an optimizer step: 1 - (device-busy ms of
one profiled step) / (wall ms a step in the traced window, loader wait
included)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "train_frames_per_s"


def read(r):
    return r.idle_share()
