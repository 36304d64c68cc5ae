"""Prompt-to-prompt video sampler for synthetic data generation.

Counterpart of ``diffusion/ptp_sampler.py`` in the JAX package (the
reference's ``InferenceDAMO_PTP_v2``, pl_trainer/inference/
inference_damo.py:159-307): denoises an (old, new) latent pair from one
shared initial noise in three phases, each a Python loop over its steps —

  phase 1 (step < sa_end): one 4-way UNet call [old, new, old, new] with
      contexts [uncond, uncond, old, new] and ``sa_share`` (the new
      branches attend with the old branches' self-attention maps);
  phase 2 (sa_end <= step < ca_end): two 2-way calls, old with the old
      context, new with the token-aligned (key, value) tuple context;
  phase 3: two 2-way calls, new with the plain new context.

``sample_ptp_pair_v1`` is the staged v1 variant (``InferenceDAMO_PTP``,
inference_damo.py:52-157): in phase 1 only the old branch is denoised and
the new branch copies it, so the pair stays identical until ``sa_end``.

Classifier-free guidance and the sampler step run in float32. Per-step
noise comes through a seam, ``noise(i, shape) -> (n_old, n_new)``; by
default both are drawn from one seeded ``torch.Generator`` on the
latent's device (the JAX package draws ``n_old = normal(sub)`` and
``n_new = normal(fold_in(sub, 1))`` with ``sub`` split off its key at each
step; a test can feed those draws through the seam).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from insv2v_torch.diffusion.schedules import SamplerTables, sampler_step
from insv2v_torch.utils.tracing import StageClock, span

__all__ = ["sample_ptp_pair", "sample_ptp_pair_v1", "frac_phase_steps", "generator_noise"]

# unet(x, t, context, sa_share) -> eps; context a tensor or a (key, value) tuple
UNetFn = Callable[..., torch.Tensor]
StepNoise = Callable[[int, tuple], Tuple[torch.Tensor, torch.Tensor]]


def frac_phase_steps(frac: float, num_steps: int) -> int:
    """Steps in a phase that ends at fraction ``frac``: the reference's
    ``i < frac * num_steps`` counted literally (the fractional step is
    included: sa_end 0.35 at 30 steps gives 11 steps, not 10)."""
    return sum(1 for i in range(num_steps) if i < frac * num_steps)


def generator_noise(generator: torch.Generator) -> StepNoise:
    """The default seam: (n_old, n_new) float32 normals from ``generator``."""
    def draw(i: int, shape: tuple):
        mk = lambda: torch.randn(tuple(shape), generator=generator, device=generator.device,
                                 dtype=torch.float32)
        return mk(), mk()

    return draw


def _sample_ptp(unet: UNetFn, tables: SamplerTables, latent, context_new, context_old,
                context_kv, uncond_context, guidance_scale, sa_end_time, ca_end_time,
                sa_steps, ca_steps, joint_phase1: bool, noise: Optional[StepNoise],
                timings: Optional[dict]) -> dict:
    s = tables.num_steps
    sa_end = frac_phase_steps(sa_end_time, s) if sa_steps is None else int(sa_steps)
    ca_end = frac_phase_steps(ca_end_time, s) if ca_steps is None else int(ca_steps)
    if not sa_end < ca_end <= s:
        raise ValueError(f"phase boundaries sa {sa_end} < ca {ca_end} <= steps {s} do not hold")
    if noise is None:
        noise = generator_noise(torch.Generator(device=latent.device).manual_seed(0))
    gs = float(guidance_scale)
    cfg = lambda e_uncond, e_cond: e_uncond + gs * (e_cond - e_uncond)
    halves = lambda e: e.float().chunk(2, dim=0)
    old = new = latent.float()
    x0_old = x0_new = latent

    def timestep(i):
        return torch.tensor(int(tables.timesteps[i]), device=latent.device)

    with StageClock(latent.device, timings) as clock:
        for i in range(sa_end):
            with span("sampler.step"):
                t = timestep(i)
                n_old, n_new = noise(i, tuple(old.shape))
                if joint_phase1:
                    ctx4 = torch.cat([uncond_context, uncond_context, context_old, context_new])
                    with span("sampler.unet"):
                        e4 = unet(torch.cat([old, new, old, new]), t, ctx4, True)
                    eu_old, eu_new, ec_old, ec_new = e4.float().chunk(4, dim=0)
                    old, x0_old = sampler_step(tables, old, cfg(eu_old, ec_old), i, n_old)
                    new, x0_new = sampler_step(tables, new, cfg(eu_new, ec_new), i, n_new)
                else:
                    with span("sampler.unet"):
                        e2 = unet(torch.cat([old, old]), t,
                                  torch.cat([uncond_context, context_old]), False)
                    old, x0_old = sampler_step(tables, old, cfg(*halves(e2)), i, n_old)
                    new, x0_new = old, x0_old
        clock.mark("phase1")
        ctx_old2 = torch.cat([uncond_context, context_old])
        kv2 = (torch.cat([uncond_context, context_kv[0]]),
               torch.cat([uncond_context, context_kv[1]]))
        ctx_new2 = torch.cat([uncond_context, context_new])
        for i in range(sa_end, s):
            with span("sampler.step"):
                t = timestep(i)
                n_old, n_new = noise(i, tuple(old.shape))
                with span("sampler.unet"):
                    e_old = unet(torch.cat([old, old]), t, ctx_old2, False)
                    e_new = unet(torch.cat([new, new]), t, kv2 if i < ca_end else ctx_new2,
                                 False)
                old, x0_old = sampler_step(tables, old, cfg(*halves(e_old)), i, n_old)
                new, x0_new = sampler_step(tables, new, cfg(*halves(e_new)), i, n_new)
            if i + 1 == ca_end:
                clock.mark("phase2")
        clock.mark("phase3")
    return {"latent": new, "latent_old": old, "pred_x0": x0_new, "pred_x0_old": x0_old}


def sample_ptp_pair(unet: UNetFn, tables: SamplerTables, latent: torch.Tensor,
                    context_new: torch.Tensor, context_old: torch.Tensor,
                    context_kv: Tuple[torch.Tensor, torch.Tensor], uncond_context: torch.Tensor,
                    guidance_scale: float = 9.0, sa_end_time: float = 0.3,
                    ca_end_time: float = 0.8, sa_steps: Optional[int] = None,
                    ca_steps: Optional[int] = None, noise: Optional[StepNoise] = None,
                    timings: Optional[dict] = None) -> dict:
    """v2 with self-attention-map sharing. ``latent`` (B, F, h, w, C) is the
    shared initial noise; contexts (B, L, D); phase boundaries as fractions
    of the steps or, overriding them, as step counts. ``timings``, when
    given, receives the wall seconds of each phase (``phase1``..``phase3``,
    the device synchronised at each end), and the call's spans get device
    intervals (``utils/tracing.py``). Returns the new (``latent``) and
    old (``latent_old``) final latents and the last predicted x0 of each."""
    return _sample_ptp(unet, tables, latent, context_new, context_old, context_kv,
                       uncond_context, guidance_scale, sa_end_time, ca_end_time, sa_steps,
                       ca_steps, True, noise, timings)


def sample_ptp_pair_v1(unet: UNetFn, tables: SamplerTables, latent: torch.Tensor,
                       context_new: torch.Tensor, context_old: torch.Tensor,
                       context_kv: Tuple[torch.Tensor, torch.Tensor],
                       uncond_context: torch.Tensor, guidance_scale: float = 9.0,
                       sa_end_time: float = 0.3, ca_end_time: float = 0.8,
                       sa_steps: Optional[int] = None, ca_steps: Optional[int] = None,
                       noise: Optional[StepNoise] = None,
                       timings: Optional[dict] = None) -> dict:
    """The staged v1 variant: the API of :func:`sample_ptp_pair`; phase 1
    denoises the old branch only and copies it to the new one."""
    return _sample_ptp(unet, tables, latent, context_new, context_old, context_kv,
                       uncond_context, guidance_scale, sa_end_time, ca_end_time, sa_steps,
                       ca_steps, False, noise, timings)
