"""Kernel A's share of its roofline in the edit's UNet steps: the least
time of its launches' work (work/kernels.py::flash at the UNet's
shapes) over its traced time."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "edit_fps"
FRAGMENTS, COUNTER, PER_LAUNCH = ("flash_fwd",), "flash_attention", 1


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "flash")
