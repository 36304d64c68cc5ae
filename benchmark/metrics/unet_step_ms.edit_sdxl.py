"""Milliseconds a denoising step of the SDXL-scale edit: the editor's
``window_k`` seconds over the UNet steps they ran (each a 3-way UNet call,
the guidance and the DDIM update)."""

LAYER = "sampler (diffusion/samplers.py, diffusion/ptp_sampler.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "edit_fps"


def read(r):
    steps = r.counts.get("unet_steps")
    if not steps or "window" not in r.spans:
        return None
    return 1e3 * r.spans["window"] / steps
