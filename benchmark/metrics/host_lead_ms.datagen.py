"""How far the device runs behind the host in the pairs' denoising steps:
device start minus host start of ``_sample_ptp``'s ``sampler.step`` (CUDA
events on the host's clock, recorded where the sampler's ``timings`` were
asked for: the traced window's pairs), the median over those steps."""

from program_spans import lead_ms, per_record, snapshot

LAYER = "sampler (diffusion/samplers.py, diffusion/ptp_sampler.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "higher", "program_span", "datagen_pairs_per_min"


def value(snap):
    return per_record(snap, "sampler.step", lead_ms)


def read(r):
    return value(snapshot())
