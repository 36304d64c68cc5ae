"""Kernel A's share of its roofline at ModelScope's head width 64 in the
4-way UNetSD steps: the least time of its launches' work
(work/kernels.py::flash at the UNetSD's shapes) over its traced time."""

LAYER = "kernels (csrc/)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "datagen_pairs_per_min"
FRAGMENTS, COUNTER, PER_LAUNCH = ("flash_fwd",), "flash_attention", 1


def read(r):
    return r.roofline(FRAGMENTS, COUNTER, PER_LAUNCH, "flash")
