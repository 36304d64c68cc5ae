"""Plain float32 reference of InsV2V's motion-compensated edit
(``InferenceIP2PVideoOpticalFlow`` of amazon-science/instruct-video-to-video,
the notebook's, ``gradio_demo.py``'s and ``insv2v_run_loveu_tgve.py``'s
path): the DDPM tables and step, the backward warp and ``resize_flow`` of
``misc_utils/flow_utils.py``, each follow-up window's flows from RAFT
(``raft.py``), the flow-anchored step and the window chain.

The models and the guidance are ``insv2v.py``'s; this file adds what the
flow path changes, and imports nothing of the program. Video tensors are
(B, F, H, W, C), images (N, H, W, C), flows (N, H, W, 2) = (u, v) in
pixels, from the query frame to the ref frame (backward warp).

  * DDPM as diffusers' ``DDPMScheduler`` with the reference's settings:
    scaled-linear betas, 'leading' spacing (t = 950, 900, ..., 0 for 20
    steps), no offset, alpha-bar 1 before t = 0, the fixed-small posterior
    variance, no clipping of x0, no noise at t = 0;
  * the flow anchoring, while ``i < correct_until``: each ref frame's
    implied-noise delta is its own; every other frame takes the refs'
    deltas warped into it by the flows, averaged with the warped validity
    masks (a field of ones warped by the same flow) as weights, where the
    masks sum over 0.5, and zero elsewhere.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import insv2v as ref
from .raft import raft_flow


# --- DDPM ------------------------------------------------------------------

def ddpm_tables(steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012) -> Dict[str, np.ndarray]:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps) ** 2
    ac = np.cumprod(1.0 - betas)
    ratio = train_steps // steps
    ts = (np.arange(steps) * ratio)[::-1]
    prev = ts - ratio
    a = ac[ts]
    a_prev = np.where(prev >= 0, ac[np.maximum(prev, 0)], 1.0)
    var = np.maximum((1 - a_prev) / (1 - a) * (1 - a / a_prev), 1e-20)
    var[ts == 0] = 0.0
    return {"t": ts, "a": a, "a_prev": a_prev, "var": var}


def _ddpm_coefs(tables, i: int):
    a, a_prev, var = (float(tables[k][i]) for k in ("a", "a_prev", "var"))
    alpha = a / a_prev
    c_x0 = math.sqrt(a_prev) * (1.0 - alpha) / (1.0 - a)
    c_xt = math.sqrt(alpha) * (1.0 - a_prev) / (1.0 - a)
    return a, c_x0, c_xt, math.sqrt(var)


def ddpm_step(tables, i: int, x, eps, noise=None):
    """x_{t-1} = c_x0 x0 + c_xt x_t + sigma n, x0 = (x_t - sqrt(1 - a) eps) / sqrt(a)."""
    a, c_x0, c_xt, sigma = _ddpm_coefs(tables, i)
    x0 = (x - math.sqrt(1.0 - a) * eps) / math.sqrt(a)
    out = c_x0 * x0 + c_xt * x
    return out + sigma * noise.float() if sigma > 0 else out


def ddpm_eps(tables, i: int, x, x_next, noise=None):
    """The noise estimate a DDPM step from ``x`` to ``x_next`` used, given
    its step noise (float64)."""
    a, c_x0, c_xt, sigma = _ddpm_coefs(tables, i)
    rest = (c_x0 / math.sqrt(a) + c_xt) * x.double() - x_next.double()
    if sigma > 0:
        rest = rest + sigma * noise.double()
    return rest * math.sqrt(a) / (c_x0 * math.sqrt(1.0 - a))


# --- flow utilities ----------------------------------------------------------

def warp(image, flow):
    """Backward warp: ``image`` (N, H, W, C) sampled at (x + u, y + v),
    bilinear, zero outside (``F.grid_sample``, ``align_corners=True``)."""
    n, h, w, _ = image.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=image.device, dtype=torch.float32),
                            torch.arange(w, device=image.device, dtype=torch.float32),
                            indexing="ij")
    x, y = gx + flow[..., 0].float(), gy + flow[..., 1].float()
    grid = torch.stack([2 * x / max(w - 1, 1) - 1, 2 * y / max(h - 1, 1) - 1], dim=-1)
    out = F.grid_sample(image.float().permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def resize_flow(flow, h: int, w: int):
    """``flow`` (N, H, W, 2) resized bilinearly to (h, w), u scaled by
    w / W and v by h / H."""
    hh, ww = flow.shape[1:3]
    out = F.interpolate(flow.float().permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    return out * torch.tensor([w / ww, h / hh], device=flow.device)


def window_flows(W_raft, raft_cfg: Dict, frames, num_ref: int, h: int, w: int, block: int = 8):
    """A window's flows (F, R, h, w, 2) at latent resolution from each
    query frame (index >= ``num_ref``) to each ref frame, and their
    validity masks (F, R, h, w, 1); the refs' rows are zero flow."""
    f = frames.shape[0]
    q = [i for i in range(num_ref, f) for _ in range(num_ref)]
    r = [j for _ in range(num_ref, f) for j in range(num_ref)]
    full = raft_flow(W_raft, raft_cfg, frames[q], frames[r], block)
    flows = torch.zeros((f, num_ref, h, w, 2), device=frames.device)
    flows[num_ref:] = resize_flow(full, h, w).reshape(f - num_ref, num_ref, h, w, 2)
    ones = torch.ones((f * num_ref, h, w, 1), device=frames.device)
    masks = warp(ones, flows.reshape(-1, h, w, 2)).reshape(f, num_ref, h, w, 1)
    return flows, masks


def propagate(delta, flows, masks):
    """The refs' deltas (B, F, h, w, C; the first R frames are the refs)
    warped into every frame and averaged, weighted by the masks, where the
    masks sum over 0.5; zero elsewhere."""
    b, _, h, w, c = delta.shape
    f, r = flows.shape[:2]
    msum = masks.sum(dim=1)
    out = []
    for k in range(b):
        src = delta[k, :r][None].expand(f, r, h, w, c).reshape(f * r, h, w, c)
        warped = warp(src, flows.reshape(f * r, h, w, 2)).reshape(f, r, h, w, c)
        avg = (warped * masks).sum(dim=1) / msum.clamp_min(1e-6)
        out.append(torch.where(msum > 0.5, avg, torch.zeros_like(avg)))
    return torch.stack(out)


# --- the edit ------------------------------------------------------------------

def flow_edit_step(W, cfg, tables, i: int, lat, cond, ctx_uncond, ctx_cond, start: int,
                   latent_ref=None, num_ref: int = 0, correct_until: int = 0,
                   text_cfg: float = 7.5, img_cfg: float = 1.2, flows=None, noise=None):
    """One step of the motion-compensated window sampler from ``lat``
    (1, F, h, w, 4): the 3-way UNet batch and its guidance (``insv2v.py``),
    the flow anchoring while ``i < correct_until`` (``flows`` the window's
    (flows, masks)), and the DDPM update with ``noise``. Returns (eps of
    the three branches, the guided and anchored eps, the next latent)."""
    a = float(tables["a"][i])
    sample = torch.cat([torch.cat([lat] * 3), torch.cat([torch.zeros_like(cond), cond, cond])],
                       dim=-1)
    ctx = torch.cat([ctx_uncond, ctx_uncond, ctx_cond])
    t = torch.full((3,), int(tables["t"][i]), device=lat.device)
    e3 = ref.unet3d(W, cfg, sample, t, ctx, start)
    e_u, e_i, e_t = e3.chunk(3)
    eps = e_u + img_cfg * (e_i - e_u) + text_cfg * (e_t - e_i)
    if latent_ref is not None and i < correct_until:
        mask = (torch.arange(lat.shape[1], device=lat.device) < num_ref).float()
        mask = mask[None, :, None, None, None]
        noise_ref = (lat - math.sqrt(a) * latent_ref) / math.sqrt(1.0 - a)
        delta = (noise_ref - eps) * mask
        eps = eps + mask * delta + (1.0 - mask) * propagate(delta, *flows)
    return e3, eps, ddpm_step(tables, i, lat, eps, noise)


def edit_latents(W, cfg, tables, cond, ctx_uncond, ctx_cond, windows: Sequence[tuple],
                 flows: Dict[int, tuple], draws: Dict[str, List[torch.Tensor]],
                 correct_until: int, text_cfg: float, img_cfg: float):
    """The window chain: every window denoised from its initial latent, the
    first from the ``init`` draw, each later one from the previous
    window's initial noise in its ref slots and a ``window`` draw in the
    rest, anchored to the previous window's output in the ref slots;
    ``flows[k]`` window k's (flows, masks). Returns the scaled latents of
    every frame (1, F, h, w, 4)."""
    step_draws = iter(draws.get("step", []))
    noisy = lambda i: float(tables["var"][i]) > 0
    outs, init, prev = [], None, None
    for k, (s0, s_n, r_n) in enumerate(windows):
        if k == 0:
            init = draws["init"][0].float()
            latent_ref = None
        else:
            init = torch.cat([init[:, -r_n:], draws["window"][k - 1].float()], dim=1)
            latent_ref = torch.cat([prev[:, -r_n:], torch.zeros_like(prev[:, r_n:])], dim=1)
        lat = init
        for i in range(len(tables["t"])):
            lat = flow_edit_step(W, cfg, tables, i, lat, cond[:, s0: s0 + s_n], ctx_uncond,
                                 ctx_cond, s0, latent_ref, r_n, correct_until, text_cfg, img_cfg,
                                 flows.get(k), next(step_draws) if noisy(i) else None)[2]
        outs.append(lat[:, r_n:])
        prev = lat
    return torch.cat(outs, dim=1)
