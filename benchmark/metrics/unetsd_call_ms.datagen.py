"""Milliseconds a UNetSD call: the sampler's phase seconds (its
``timings``) over the calls they ran (a 4-way call a phase-1 step, two
2-way calls a later step), guidance and DDIM updates included."""

LAYER = "sampler (diffusion/samplers.py, diffusion/ptp_sampler.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "datagen_pairs_per_min"


def read(r):
    calls = r.counts.get("unetsd_calls")
    phases = [r.spans.get(k) for k in ("phase1", "phase2", "phase3")]
    if not calls or any(p is None for p in phases):
        return None
    return 1e3 * sum(phases) / calls
