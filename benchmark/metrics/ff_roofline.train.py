"""Kernel B's share of its roofline at training's shapes over one
profiled optimizer step: its forward launches and remat's reruns (its
gate and output kernels, two a launch)."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_frames_per_s"
FRAGMENTS, COUNTER, PER_LAUNCH = ("ff_gate", "ff_out"), "fused_geglu_ff", 2


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "ff")
