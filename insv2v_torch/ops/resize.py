"""Spatial resize and flow warping on channels-last tensors.

Counterpart of ``ops/resize.py`` in the JAX package, written as the same
gathers and lerps so that the port agrees with it to float32 rounding:

  * ``nearest_upsample_2x`` / ``nearest_resize``: torch's nearest rule
    (``src = floor(dst * src_size / dst_size)``);
  * ``bilinear_resize``: torch's bilinear rule (half-pixel centres, or
    ``align_corners``), indices and weights clamped at the border;
  * ``warp_image``: backward warp by a flow field, bilinear at
    ``(x + u, y + v)`` with ``align_corners=True`` semantics, each of the
    four corners zeroed on its own when it falls outside the image;
  * ``resize_flow``: a flow field resized with its vectors scaled;
  * ``check_flow_consistency``: the forward/backward reliability mask.

``F.grid_sample`` would compute ``warp_image`` too, but its [-1, 1]
normalisation rounds the sample positions differently; the explicit
gather keeps the JAX function's arithmetic.
"""

from __future__ import annotations

import torch

__all__ = ["nearest_upsample_2x", "nearest_resize", "bilinear_resize", "warp_image",
           "resize_flow", "check_flow_consistency"]


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Each pixel of ``x`` (..., H, W, C) becomes a 2x2 block, as torch
    ``F.interpolate(scale_factor=2, mode='nearest')`` does."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of ``x`` (..., H, W, C) to (h, w): source index
    ``floor(dst * H / h)``."""
    hh, ww = x.shape[-3], x.shape[-2]
    rows = torch.floor(torch.arange(h, device=x.device, dtype=torch.float32) * (hh / h)).long()
    cols = torch.floor(torch.arange(w, device=x.device, dtype=torch.float32) * (ww / w)).long()
    return x.index_select(-3, rows).index_select(-2, cols)


def bilinear_resize(x: torch.Tensor, h: int, w: int, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``x`` (..., H, W, C) to (h, w), torch semantics,
    computed in float32 and returned in ``x.dtype``."""
    hh, ww = x.shape[-3], x.shape[-2]
    xf = x.float()
    f32 = dict(device=x.device, dtype=torch.float32)
    if align_corners and h > 1 and w > 1:
        ys = torch.linspace(0.0, hh - 1.0, h, **f32)
        xs = torch.linspace(0.0, ww - 1.0, w, **f32)
    else:
        ys = (torch.arange(h, **f32) + 0.5) * (hh / h) - 0.5
        xs = (torch.arange(w, **f32) + 0.5) * (ww / w) - 0.5
    y0 = torch.floor(ys).clamp(0, hh - 1).long()
    x0 = torch.floor(xs).clamp(0, ww - 1).long()
    y1 = (y0 + 1).clamp(0, hh - 1)
    x1 = (x0 + 1).clamp(0, ww - 1)
    wy = (ys - y0).clamp(0.0, 1.0).reshape(h, 1, 1)
    wx = (xs - x0).clamp(0.0, 1.0).reshape(1, w, 1)
    top, bot = xf.index_select(-3, y0), xf.index_select(-3, y1)
    tl, tr = top.index_select(-2, x0), top.index_select(-2, x1)
    bl, br = bot.index_select(-2, x0), bot.index_select(-2, x1)
    out = (tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx
           + bl * wy * (1 - wx) + br * wy * wx)
    return out.to(x.dtype)


def warp_image(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` (N, H, W, C) by ``flow`` (N, H, W, 2) =
    (u, v) in pixels: bilinear samples at ``(x + u, y + v)``, zero outside.
    Computed in float32, returned in ``image.dtype``."""
    n, h, w, c = image.shape
    imf = image.float().reshape(n, h * w, c)
    gy, gx = torch.meshgrid(torch.arange(h, device=image.device, dtype=torch.float32),
                            torch.arange(w, device=image.device, dtype=torch.float32),
                            indexing="ij")
    sx = gx[None] + flow[..., 0].float()
    sy = gy[None] + flow[..., 1].float()
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    def sample(yi, xi):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        flat = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(n, -1, 1)
        vals = torch.gather(imf, 1, flat.expand(n, h * w, c)).reshape(n, h, w, c)
        return vals * inb[..., None].float()

    out = (sample(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + sample(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + sample(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + sample(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return out.to(image.dtype)


def resize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Resize ``flow`` (N, H, W, 2) to (h, w), scaling u by w/W and v by
    h/H; float32."""
    hh, ww = flow.shape[1], flow.shape[2]
    scale = torch.tensor([w / ww, h / hh], device=flow.device, dtype=torch.float32)
    return bilinear_resize(flow.float() * scale, h, w, align_corners=False)


def check_flow_consistency(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor) -> torch.Tensor:
    """Forward/backward consistency mask (N, H, W), float32: a pixel is
    reliable when the round trip is small against the motion and it does
    not sit on a motion edge. The central differences wrap at the border
    (``roll``), as in the JAX function."""
    f = flow_fwd.float()
    gx = (torch.roll(f[..., 0], -1, dims=2) - torch.roll(f[..., 0], 1, dims=2)) * 0.5
    gy = (torch.roll(f[..., 1], -1, dims=1) - torch.roll(f[..., 1], 1, dims=1)) * 0.5
    motion_edge = gx * gx + gy * gy
    bwd_at_fwd = warp_image(flow_bwd.float(), f)
    u, v = f[..., 0], f[..., 1]
    u2, v2 = bwd_at_fwd[..., 0], bwd_at_fwd[..., 1]
    roundtrip = (u + u2) ** 2 + (v + v2) ** 2
    mag = u * u + v * v + u2 * u2 + v2 * v2
    reliable = (roundtrip < 0.01 * mag + 0.5) & (motion_edge <= 0.01 * (u * u + v * v) + 0.002)
    return reliable.float()
