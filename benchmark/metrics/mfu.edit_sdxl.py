"""Model FLOPs of the SDXL-scale edits completed in the traced window
(counted once over the float32 reference on the meta device) over the
window's wall time, against the bf16 peak of 989 TFLOP/s."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "edit_fps"


def read(r):
    return r.mfu()
