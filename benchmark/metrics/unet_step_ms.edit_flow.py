"""Milliseconds a denoising step of the motion-compensated edit: the
editor's ``window_k`` seconds (its ``flows_k`` apart) over the UNet steps
they ran (each a 3-way UNet call, the guidance, the flow anchoring in the
first half of a follow-up window, and the DDPM update)."""

LAYER = "sampler (diffusion/samplers.py, diffusion/ptp_sampler.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "edit_fps"


def read(r):
    steps = r.counts.get("unet_steps")
    if not steps or "window" not in r.spans:
        return None
    return 1e3 * r.spans["window"] / steps
