"""Model FLOPs of one rank's share of the optimizer steps completed in the
traced window (its 8 microbatches' text and VAE encodes, UNet forward
and backward to the motion modules, remat's rerun left out; counted over
the reference on the meta device) over the window's wall time, against
one card's bf16 peak of 989 TFLOP/s: each card's share of its peak."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_frames_per_s"


def read(r):
    return r.mfu()
