"""Device-busy milliseconds a 4-way phase-1 UNetSD step: the union of the
device operations' intervals over the profiled stretch, per step."""

LAYER = "model (models/unet3d.py, models/modelscope_t2v.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "datagen_pairs_per_min"


def read(r):
    return r.busy_ms_per_call()
