"""Model FLOPs of the motion-compensated edits completed in the traced
window (the edit's, counted over the float32 reference on the meta
device, and RAFT's 96 pairs, ``work/raft.py``) over the window's wall
time, against the bf16 peak of 989 TFLOP/s."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "edit_fps"


def read(r):
    return r.mfu()
