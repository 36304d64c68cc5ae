"""How far the device runs behind the host in the edit's denoising steps:
device start minus host start of ``sampler.step`` (CUDA events on the
host's clock, recorded where the editor's ``timings`` were asked for: the
traced window's edits), the median over those steps. Near 0 the device
waited for the host at that step; a faster kernel then moves nothing."""

from program_spans import lead_ms, per_record, snapshot

LAYER = "sampler (diffusion/samplers.py, diffusion/ptp_sampler.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "higher", "program_span", "edit_fps"


def value(snap):
    return per_record(snap, "sampler.step", lead_ms)


def read(r):
    return value(snapshot())
