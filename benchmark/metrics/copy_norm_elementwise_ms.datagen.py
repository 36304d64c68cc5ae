"""Device milliseconds a 4-way UNetSD step in copies, norms and the
elementwise kernels no other class claims (``kernel_classes.py``)."""

LAYER = "ops (ops/, cuDNN, cuBLAS, ATen)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "datagen_pairs_per_min"


def read(r):
    return r.class_ms_per_call(("copies", "norms", "other elementwise"))
