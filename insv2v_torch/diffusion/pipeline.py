"""VideoEditor: the single-video editing pipeline on the GPU.

Counterpart of ``diffusion/pipeline.py`` in the JAX package: tokenize ->
CLIP encode -> chunked VAE encode (16 frames) of the conditioning video
-> sliding-window dual-CFG denoise chain with ref-frame anchoring,
optionally motion-compensated: each follow-up window's optical flow from
its query frames to its ref frames, computed once per window from the
pixel frames, warps the refs' per-step deltas -> chunked VAE decode (8
frames).

Randomness goes through one seam, ``noise(kind, shape)``, which returns
float32 standard normals on the editor's device. The kinds, in the order
a call draws them: ``"encode"`` once per VAE chunk (the posterior
sample), ``"init"`` for the first window's latent, ``"window"`` for the
new frames of each follow-up window, and ``"step"`` for sampler steps
with non-zero variance (DDPM; never DDIM at eta 0). The default draws
from a ``torch.Generator`` seeded with ``seed``; a test hands in the
exact draws of a JAX run instead.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from insv2v_torch._device import resolve_device
from insv2v_torch.diffusion.samplers import sample_video_window, split_windows
from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
from insv2v_torch.models.vae import SD_SCALE_FACTOR
from insv2v_torch.ops.resize import warp_image
from insv2v_torch.utils.flow import get_flow_estimator, window_flows

__all__ = ["VideoEditor", "GeneratorNoise"]

Noise = Callable[[str, tuple], torch.Tensor]


class GeneratorNoise:
    """The default noise seam: normals from one seeded torch.Generator."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def __call__(self, kind: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device,
                           dtype=torch.float32)


class VideoEditor:
    """Args:
      unet, vae, text_encoder: the port's modules (moved to ``device`` and
        served in ``dtype``).
      tokenizer: callable(list[str]) -> (B, 77) integer ids.
      scheduler: 'ddpm' or 'ddim'; num_steps: denoising steps.
      device: defaults to ``cuda`` and raises when no GPU is present;
        ``"cpu"`` runs the plain PyTorch path.
      dtype: the served weight and activation dtype (bf16 by default).
    """

    def __init__(self, unet, vae, text_encoder, tokenizer=None, scheduler: str = "ddpm",
                 num_steps: int = 20, scale_factor: float = SD_SCALE_FACTOR,
                 beta_schedule_kwargs: Optional[dict] = None, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet = unet.to(self.device, dtype).eval()
        self.vae = vae.to(self.device, dtype).eval()
        self.text_encoder = text_encoder.to(self.device, dtype).eval()
        if tokenizer is None:
            from insv2v_torch.text.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        self.scale_factor = scale_factor
        self.num_steps = num_steps
        self.tables = make_sampler_tables(
            DiffusionSchedule.create(**(beta_schedule_kwargs or {})), num_steps, kind=scheduler)

    # --- stages ------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, prompts: List[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.tokenizer(prompts)), device=self.device)
        return self.text_encoder(ids)

    @torch.no_grad()
    def encode_video(self, frames, noise: Noise, chunk: int = 16) -> torch.Tensor:
        """frames (F, H, W, 3) in [-1, 1] -> UNSCALED sampled latents
        (F, H/8, W/8, 4), float32, one posterior draw per chunk."""
        x = torch.as_tensor(frames, device=self.device)
        outs = []
        for i in range(0, x.shape[0], chunk):
            post = self.vae.posterior(x[i: i + chunk])
            outs.append(post.sample(noise("encode", post.mean.shape)))
        return torch.cat(outs, dim=0)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, chunk: int = 8) -> np.ndarray:
        """Scaled latents (F, h, w, 4) -> frames (F, H, W, 3) in [-1, 1]."""
        z = latents / self.scale_factor
        outs = [self.vae.decode(z[i: i + chunk]).float().clamp(-1.0, 1.0).cpu()
                for i in range(0, z.shape[0], chunk)]
        return torch.cat(outs, dim=0).numpy()

    def _flows_and_masks(self, estimator, frames: np.ndarray, num_ref: int, latent_hw):
        """A window's flows (F, R, h, w, 2) from its pixel frames, at
        latent resolution on the editor's device, and their validity
        masks (F, R, h, w, 1): a field of ones warped by each flow."""
        flows = window_flows(estimator, frames, num_ref, latent_hw).to(self.device)
        f, r, h, w, _ = flows.shape
        ones = flows.new_ones((f * r, h, w, 1))
        masks = warp_image(ones, flows.reshape(f * r, h, w, 2)).reshape(f, r, h, w, 1)
        return flows, masks

    def _unet(self, sample, t, ctx, video_start_index):
        return self.unet(sample, t, ctx, video_start_index=video_start_index)

    # --- public API --------------------------------------------------------

    @torch.no_grad()
    def __call__(self, frames: np.ndarray, edit_prompt: Union[str, Sequence[str]], *,
                 text_cfg: float = 7.5, video_cfg: float = 1.2,
                 frames_per_window: int = 16, num_ref_frames: int = 4,
                 noise_correct_step: float = 0.5, negative_prompt: str = "",
                 use_motion_compensation: bool = False, flow_estimator=None, seed: int = 0,
                 noise: Optional[Noise] = None, timings: Optional[dict] = None) -> np.ndarray:
        """Edit a video. frames (F, H, W, 3) float in [-1, 1]. Returns the
        edited frames (F, H, W, 3), or (B, F, H, W, 3) for a list of prompts
        (one shared chain: the same latents and noise for every prompt).
        ``use_motion_compensation`` spreads the ref frames' deltas by
        optical flow from ``flow_estimator`` (default
        ``get_flow_estimator("auto")`` on the editor's device).
        ``timings``, when given, receives the wall seconds of each stage,
        of each window's denoise (``window_k``) and of each window's flow
        (``flows_k``; the device is synchronised at stage ends)."""
        if use_motion_compensation and flow_estimator is None:
            flow_estimator = get_flow_estimator(device=self.device)
        clock = _StageClock(self.device, timings)
        noise = noise or GeneratorNoise(seed, self.device)
        prompts = [edit_prompt] if isinstance(edit_prompt, str) else list(edit_prompt)
        b = len(prompts)

        text_cond = self.encode_text(prompts)
        text_uncond = self.encode_text([negative_prompt]).expand_as(text_cond)
        clock.mark("text")
        cond = self.encode_video(frames, noise)[None]  # (1, F, h, w, 4)
        cond = cond.expand((b,) + cond.shape[1:])
        clock.mark("vae_encode")

        windows = split_windows(frames.shape[0], frames_per_window, num_ref_frames)
        _, _, h, w, ch = cond.shape
        share = lambda t: t.expand((b,) + t.shape[1:])
        step_noise = lambda i, shape: noise("step", shape)
        run = lambda init, spec, ref, n_ref, flows=None, masks=None: sample_video_window(
            self._unet, self.tables, init, cond[:, spec.start: spec.start + spec.num_frames],
            text_cond, text_uncond, text_cfg=text_cfg, img_cfg=video_cfg,
            video_start_index=spec.start, latent_ref=ref, num_ref_frames=n_ref,
            noise_correct_step=noise_correct_step, flows=flows, flow_masks=masks,
            step_noise=step_noise, share_batch_noise=True)["latent"]

        w0 = windows[0]
        init = share(noise("init", (1, w0.num_frames, h, w, ch)))
        latent_pred = run(init, w0, None, 0)
        outs = [latent_pred]
        clock.mark("window_0")
        for k, spec in enumerate(windows[1:], start=1):
            n_new = spec.num_frames - spec.num_ref
            new_noise = share(noise("window", (1, n_new, h, w, ch)))
            # ref slots carry the previous window's *initial* noise; the
            # anchor is the previous *output*
            init = torch.cat([init[:, -spec.num_ref:], new_noise], dim=1)
            ref = torch.cat([latent_pred[:, -spec.num_ref:],
                             latent_pred.new_zeros((b, n_new, h, w, ch))], dim=1)
            flows = masks = None
            if use_motion_compensation:
                flows, masks = self._flows_and_masks(
                    flow_estimator, frames[spec.start: spec.start + spec.num_frames],
                    spec.num_ref, (h, w))
                clock.mark(f"flows_{k}")
            latent_pred = run(init, spec, ref, spec.num_ref, flows, masks)
            outs.append(latent_pred[:, spec.num_ref:])
            clock.mark(f"window_{k}")

        edited = torch.cat(outs, dim=1)  # (B, F, h, w, 4)
        decoded = self.decode_latents(edited.reshape((-1,) + edited.shape[2:]))
        clock.mark("vae_decode")
        decoded = decoded.reshape(tuple(edited.shape[:2]) + decoded.shape[1:])
        return decoded[0] if isinstance(edit_prompt, str) else decoded


class _StageClock:
    """Wall seconds per stage into ``timings``, synchronising the device
    at each mark; does nothing when ``timings`` is None."""

    def __init__(self, device: torch.device, timings: Optional[dict]):
        import time

        self._now = time.perf_counter
        self.device, self.timings = device, timings
        self.t = self._sync_now()

    def _sync_now(self):
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._now()

    def mark(self, name: str):
        if self.timings is None:
            return
        t = self._sync_now()
        self.timings[name] = t - self.t
        self.t = t
