"""Device-busy milliseconds a 3-way SDXL UNet3D step: the union of the
device operations' intervals over the profiled stretch of whole steps,
per step."""

LAYER = "model (models/unet3d.py, models/modelscope_t2v.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "edit_fps"


def read(r):
    return r.busy_ms_per_call()
