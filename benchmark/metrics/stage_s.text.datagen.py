"""Seconds a pair in its text stage: the caption diff, the three OpenCLIP
encodes and the token-aligned (key, value) contexts (the driver's span,
synchronised at its end, as the generator's stage clock)."""

LAYER = "apps and pipeline (diffusion/pipeline.py, apps/)"
UNIT, BETTER, SOURCE, MOVES = "s", "lower", "host_clock", "datagen_pairs_per_min"


def read(r):
    return r.spans["text"] / r.units if r.units and "text" in r.spans else None
