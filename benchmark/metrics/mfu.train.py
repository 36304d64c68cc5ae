"""Model FLOPs of the optimizer steps completed in the traced window (text
and VAE encodes, the UNet forward and its backward to the motion
modules, remat's rerun left out; counted over the reference on the meta
device) over the window's wall time, against the bf16 peak of 989
TFLOP/s."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_frames_per_s"


def read(r):
    return r.mfu()
