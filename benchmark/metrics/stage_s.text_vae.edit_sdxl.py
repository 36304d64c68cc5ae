"""Seconds an SDXL-scale edit in its text (both towers), vae_encode and
vae_decode stages (the editor's ``timings``, synchronised at each
stage's end)."""

LAYER = "apps and pipeline (diffusion/pipeline.py, apps/)"
UNIT, BETTER, SOURCE, MOVES = "s", "lower", "program_span", "edit_fps"


def read(r):
    parts = [r.spans.get(k) for k in ("text", "vae_encode", "vae_decode")]
    if not r.units or any(p is None for p in parts):
        return None
    return sum(parts) / r.units
