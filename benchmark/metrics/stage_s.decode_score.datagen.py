"""Seconds a pair in the VAE decode of both videos and the four CLIP
scores (the driver's spans, synchronised at their ends)."""

LAYER = "apps and pipeline (diffusion/pipeline.py, apps/)"
UNIT, BETTER, SOURCE, MOVES = "s", "lower", "host_clock", "datagen_pairs_per_min"


def read(r):
    if not r.units or "decode" not in r.spans or "score" not in r.spans:
        return None
    return (r.spans["decode"] + r.spans["score"]) / r.units
