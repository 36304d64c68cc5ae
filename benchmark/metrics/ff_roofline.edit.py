"""Kernel B's share of its roofline in the edit's UNet steps (its gate
and output kernels together, two a launch)."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "edit_fps"
FRAGMENTS, COUNTER, PER_LAUNCH = ("ff_gate", "ff_out"), "fused_geglu_ff", 2


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "ff")
