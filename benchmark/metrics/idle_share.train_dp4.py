"""Rank 0's idle share in an optimizer step of the four-card cell: 1 -
(device-busy ms of one profiled step) / (wall ms a step in the traced
window: its loader wait, its step and its wait for the other ranks)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "train_frames_per_s"


def read(r):
    return r.idle_share()
