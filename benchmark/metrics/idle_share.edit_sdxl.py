"""The device's idle share in a 3-way SDXL UNet step: 1 - (device-busy ms
a step over the profiled stretch) / (wall ms a step in the traced
window, from the sampler's synchronised spans)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "edit_fps"


def read(r):
    return r.idle_share()
