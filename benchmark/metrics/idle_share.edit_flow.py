"""The device's idle share in a 3-way UNet step of the motion-compensated
edit: 1 - (device-busy ms a step over the profiled stretch) / (wall ms a
step in the traced window, from the editor's synchronised stages)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "edit_fps"


def read(r):
    return r.idle_share()
