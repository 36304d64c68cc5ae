"""Model FLOPs of the pairs completed in the traced window (counted once
over the float32 reference on the meta device, at the pairs' mean phase
lengths) over the window's wall time, against the bf16 peak of 989
TFLOP/s."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "datagen_pairs_per_min"


def read(r):
    return r.mfu()
