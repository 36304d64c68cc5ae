"""Kernel B's share of its roofline in the SDXL UNet3D's 3-way steps (its
gate and output kernels together, two a launch), most of its work at
C = 1280 in the depth-10 stacks."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "edit_fps"
FRAGMENTS, COUNTER, PER_LAUNCH = ("ff_gate", "ff_out"), "fused_geglu_ff", 2


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "ff")
