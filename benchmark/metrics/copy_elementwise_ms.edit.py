"""Device milliseconds a UNet step in copies and in the elementwise
kernels that no other class claims (``kernel_classes.py``)."""

LAYER = "ops (ops/, cuDNN, cuBLAS, ATen)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "edit_fps"


def read(r):
    return r.class_ms_per_call(("copies", "other elementwise"))
