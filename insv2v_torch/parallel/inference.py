"""The window sampler over several ranks: frames or videos sharded.

Counterpart of the JAX package's multi-chip inference: the window sampler
jitted with the video batch sharded over the data axis (the LOVEU sweep
fanned out over a slice), and ``INSV2V_SP_AXIS``'s frame-sharded UNet
(one video's window split by frames, ``models/unet3d.py`` there). Every
rank passes the whole window; each computes its share and the results are
all-gathered, so every rank returns the unsharded window's outputs. The
step noise is drawn at the window's full shape on every rank (the same
seeded source) and sliced, so the sharded window equals the unsharded one.
"""

from __future__ import annotations

from typing import Callable, Optional

from insv2v_torch.diffusion.samplers import sample_video_window
from insv2v_torch.parallel.dist import Group, frame_parallel, shard_range

__all__ = ["frame_sharded_window", "batch_sharded_window"]

_OUTPUTS = ("latent", "pred_x0")


def frame_sharded_window(unet, tables, latent, img_cond, text_cond, text_uncond,
                         group: Group, *, latent_ref=None, **kw) -> dict:
    """``sample_video_window`` with the frame axis sharded over ``group``:
    rank r denoises frames ``[r*F/R, (r+1)*F/R)`` of ``latent``, ``img_cond``
    and ``latent_ref`` (B, F, h, w, C) under ``frame_parallel``; ``flows``,
    ``flow_masks`` and ``step_noise`` pass whole (the sampler slices them).
    Returns the latent and last x0 prediction of all F frames."""
    frames = shard_range(latent.shape[1], group.rank, group.size)
    with frame_parallel(group):
        out = sample_video_window(
            unet, tables, latent[:, frames], img_cond[:, frames], text_cond, text_uncond,
            latent_ref=None if latent_ref is None else latent_ref[:, frames], **kw)
    return {k: group.all_gather_dim(out[k], 1) for k in _OUTPUTS}


def batch_sharded_window(unet, tables, latent, img_cond, text_cond, text_uncond,
                         group: Group, *, latent_ref=None,
                         step_noise: Optional[Callable] = None,
                         share_batch_noise: bool = False, **kw) -> dict:
    """``sample_video_window`` with the batch of videos sharded over
    ``group``: rank r denoises videos ``[r*B/R, (r+1)*B/R)``; the step
    noise is drawn for all B videos and sliced. ``flows``/``flow_masks``
    (one set shared by the batch) pass whole. Returns the latent and last
    x0 prediction of all B videos."""
    rows = shard_range(latent.shape[0], group.rank, group.size)
    noise = step_noise
    if step_noise is not None and not share_batch_noise:
        b = latent.shape[0]
        noise = lambda i, shape: step_noise(i, (b,) + tuple(shape[1:]))[rows]
    out = sample_video_window(
        unet, tables, latent[rows], img_cond[rows], text_cond[rows], text_uncond[rows],
        latent_ref=None if latent_ref is None else latent_ref[rows], step_noise=noise,
        share_batch_noise=share_batch_noise, **kw)
    return {k: group.all_gather_dim(out[k], 0) for k in _OUTPUTS}
