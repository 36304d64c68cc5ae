"""Validation sampling and preview grids for training.

Counterpart of ``training/validation.py`` in the JAX package: a DDIM edit
of a validation batch through the port's ``sample_video_window`` (dual
CFG, one window), decoded by the VAE, plus the x0-hat of the first frame
at four steps of the denoise trajectory. Previews land on disk as PNG
grids (cv2 is imported only when one is written).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from insv2v_torch.diffusion.samplers import sample_video_window
from insv2v_torch.diffusion.schedules import make_sampler_tables

__all__ = ["make_validation_fn", "save_preview_grid"]

_BOS, _EOS = 49406, 49407  # CLIP's start and end tokens: the empty prompt


def make_validation_fn(trainer, num_steps: int = 20, text_cfg: float = 7.5,
                       img_cfg: float = 1.2):
    """``validate(batch, generator=None, draws=None)`` -> {'pred' (B, F, H,
    W, 3), 'trajectory' (4, H, W, 3)}, both clipped to [-1, 1]. ``draws``
    may hold the posterior normals ``enc`` and the initial ``latent``."""
    tables = make_sampler_tables(trainer.schedule, num_steps, kind="ddim")
    unet, vae, text = trainer.unet, trainer.vae, trainer.text_encoder
    sf = trainer.cfg.scale_factor
    dev = trainer.device

    @torch.no_grad()
    def validate(batch: Mapping, generator: Optional[torch.Generator] = None,
                 draws: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        given = dict(draws or {})

        def draw(key, shape):
            if key in given:
                return torch.as_tensor(given[key], device=dev)
            return torch.randn(tuple(shape), generator=generator, device=dev)

        video = torch.as_tensor(batch["input_video"], device=dev)
        b, f = video.shape[:2]
        post = vae.posterior(video.reshape((b * f,) + video.shape[2:]))
        cond = post.sample(draw("enc", post.mean.shape))
        cond = cond.reshape((b, f) + cond.shape[1:])
        ids = torch.as_tensor(batch["prompt_ids"], device=dev)
        text_cond = text(ids)
        uncond_ids = torch.full_like(ids, _EOS)
        uncond_ids[:, 0] = _BOS
        text_uncond = text(uncond_ids)
        latent = draw("latent", cond.shape)
        out = sample_video_window(
            lambda s, t, c, vsi: unet(s, t, c, video_start_index=vsi), tables, latent, cond,
            text_cond, text_uncond, text_cfg=text_cfg, img_cfg=img_cfg, return_all=True)
        lat = out["latent"]
        frames = vae.decode(lat.reshape((b * f,) + lat.shape[2:]) / sf).float()
        n = tables.num_steps
        traj = vae.decode(out["all_pred"][[0, n // 3, (2 * n) // 3, n - 1], 0, 0] / sf).float()
        return {"pred": frames.reshape((b, f) + frames.shape[1:]).clamp(-1.0, 1.0),
                "trajectory": traj.clamp(-1.0, 1.0)}

    return validate


def _to_uint8(frames: np.ndarray) -> np.ndarray:
    return (np.clip(frames, -1.0, 1.0) * 127.5 + 127.5).round().astype(np.uint8)


def save_preview_grid(batch: Mapping[str, Any], pred: np.ndarray, out_dir: str, step: int,
                      max_items: int = 1, trajectory: Optional[np.ndarray] = None) -> str:
    """input | edited | pred rows (and the x0-hat trajectory row when
    given) of the first video as one PNG; returns its path."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"preview_step{step:08d}.png")
    n = min(max_items, pred.shape[0])
    rows = [np.concatenate(list(np.asarray(frames[0])), axis=1)
            for frames in (batch["input_video"][:n], batch["edited_video"][:n], pred[:n])]
    if trajectory is not None:
        traj_row = np.concatenate(list(np.asarray(trajectory)), axis=1)
        width = rows[0].shape[1]
        if traj_row.shape[1] < width:
            traj_row = np.pad(traj_row, ((0, 0), (0, width - traj_row.shape[1]), (0, 0)))
        rows.append(traj_row[:, :width])
    grid = _to_uint8(np.concatenate(rows, axis=0))
    cv2.imwrite(path, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
    return path
