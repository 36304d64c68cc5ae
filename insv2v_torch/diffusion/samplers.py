"""Dual-CFG video-window sampler.

Counterpart of ``diffusion/samplers.py`` in the JAX package: the 3-way
CFG batch (uncond / img-cond / img+text-cond) runs as ONE UNet call per
step, and follow-up windows anchor their first frames to the previous
window's output through the implied-noise delta of those frames. The
JAX ``lax.scan`` is a Python loop here. Latents are (B, F, h, w, C).

Randomness: the per-step sampler noise comes from a callable
``step_noise(i, shape)`` (see ``VideoEditor``'s noise seam), drawn only on
steps whose variance is non-zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from insv2v_torch.diffusion.schedules import SamplerTables, sampler_step

__all__ = ["rescale_noise_cfg", "dual_cfg_eps", "sample_video_window", "split_windows",
           "WindowSpec"]

# unet(sample_bfhwc, t_b, context_bld, video_start_index) -> eps
UnetApply = Callable[..., torch.Tensor]


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """arXiv 2305.08891 section 3.4 overexposure fix."""
    axes = tuple(range(1, noise_cfg.ndim))
    std_text = noise_pred_text.std(dim=axes, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=axes, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def dual_cfg_eps(unet: UnetApply, latent, img_cond, t: int, text_uncond, text_cond,
                 text_cfg: float, img_cfg: float, video_start_index: int,
                 guidance_rescale: float = 0.0):
    """One fused 3xCFG UNet call + guidance combine::

            e1(uncond) | e2(img)  | e3(img+text)
      text      x      |    x     |     v
      img       x      |    v     |     v
    """
    b = latent.shape[0]
    lat_in = torch.cat([latent, latent, latent], dim=0)
    cond_in = torch.cat([torch.zeros_like(img_cond), img_cond, img_cond], dim=0)
    sample = torch.cat([lat_in, cond_in.to(lat_in.dtype)], dim=-1)
    ctx = torch.cat([text_uncond, text_uncond, text_cond], dim=0)
    t_b = torch.full((3 * b,), int(t), dtype=torch.int64, device=latent.device)
    e1, e2, e3 = unet(sample, t_b, ctx, video_start_index).float().chunk(3, dim=0)
    eps = e1 + img_cfg * (e2 - e1) + text_cfg * (e3 - e2)
    if guidance_rescale > 0:
        eps = rescale_noise_cfg(eps, e1, guidance_rescale)
    return eps


def sample_video_window(unet: UnetApply, tables: SamplerTables, latent, img_cond,
                        text_cond, text_uncond, *, text_cfg: float = 7.5,
                        img_cfg: float = 1.2, guidance_rescale: float = 0.0,
                        video_start_index: int = 0, latent_ref=None,
                        num_ref_frames: int = 0, noise_correct_step: float = 0.0,
                        flows=None, step_noise: Optional[Callable] = None,
                        share_batch_noise: bool = False, return_all: bool = False) -> dict:
    """Denoise one window. First window: ``latent_ref=None``.

    Follow-up windows: ``latent`` enters with its first ``num_ref_frames``
    frames carrying the previous window's initial noise, ``latent_ref``
    holds the previous window's outputs in those slots, and for the
    first ``noise_correct_step`` fraction of steps the ref frames' implied
    noise replaces their eps while the other frames get the ref frames'
    mean delta. ``share_batch_noise`` draws one step-noise field of batch
    1 and broadcasts it over the batch.
    """
    if flows is not None:
        raise NotImplementedError(
            "flow-compensated windows are ROADMAP Queue 1 item 8 (flow-compensated edit)")
    num_steps = tables.num_steps
    f = latent.shape[1]
    correct_until = math.ceil(noise_correct_step * num_steps)
    ref_mask = (torch.arange(f, device=latent.device) < num_ref_frames).float()
    ref_mask = ref_mask[None, :, None, None, None]
    lat = latent.float()
    all_latent, all_x0 = [], []
    for i in range(num_steps):
        eps = dual_cfg_eps(unet, lat, img_cond, int(tables.timesteps[i]), text_uncond,
                           text_cond, text_cfg, img_cfg, video_start_index,
                           guidance_rescale)
        if latent_ref is not None and i < correct_until:
            a_t = float(tables.alpha_prod[i])
            noise_ref = (lat - math.sqrt(a_t) * latent_ref.float()) / math.sqrt(1.0 - a_t)
            delta_ref = (noise_ref - eps) * ref_mask  # zero on non-ref frames
            n_ref = max(float(num_ref_frames), 1.0)
            delta_mean = delta_ref.sum(dim=1, keepdim=True) / n_ref
            eps = eps + ref_mask * delta_ref + (1.0 - ref_mask) * delta_mean
        noise = None
        if tables.variance[i] > 0:
            if step_noise is None:
                raise ValueError(f"{tables.kind} step {i} needs noise: pass step_noise")
            nshape = (1,) + tuple(lat.shape[1:]) if share_batch_noise else tuple(lat.shape)
            noise = step_noise(i, nshape).to(lat).expand(lat.shape)
        lat, x0 = sampler_step(tables, lat, eps, i, noise)
        if return_all:
            all_latent.append(lat)
        all_x0.append(x0)
    out = {"latent": lat, "pred_x0": all_x0[-1]}
    if return_all:
        out.update(all_latent=torch.stack(all_latent), all_pred=torch.stack(all_x0))
    return out


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    start: int  # absolute index of the window's first frame (incl. refs)
    num_frames: int  # total frames in the window
    num_ref: int  # leading frames that are refs from the previous window


def split_windows(total_frames: int, frames_per_window: int = 16,
                  num_ref_frames: int = 4) -> List[WindowSpec]:
    """The reference decomposition: the first window is full; later
    windows re-use the previous one's trailing frames as refs; a short
    final remainder takes extra refs so every window has the same length."""
    if total_frames <= frames_per_window:
        return [WindowSpec(0, total_frames, 0)]
    windows = [WindowSpec(0, frames_per_window, 0)]
    ptr = frames_per_window
    while ptr < total_frames:
        remaining = total_frames - ptr
        n_new = (remaining if remaining < frames_per_window
                 else frames_per_window - num_ref_frames)
        n_ref = frames_per_window - n_new
        windows.append(WindowSpec(ptr - n_ref, frames_per_window, n_ref))
        ptr += n_new
    return windows
