"""Kernel A's share of its roofline at head width 64 in the SDXL UNet3D's
3-way steps (self-attention at S = 2304 and 576): the least time of its
launches' work (work/sdxl.py at the UNet's shapes) over its traced time."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "edit_fps"
FRAGMENTS, COUNTER, PER_LAUNCH = ("flash_fwd",), "flash_attention", 1


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "flash")
