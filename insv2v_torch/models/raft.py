"""RAFT optical flow (Teed & Deng, ECCV 2020) as torch modules, the flow
model of the motion-compensated edit.

Counterpart of ``models/raft.py`` in the JAX package, with princeton-vl's
checkpoint layout (``fnet.*``, ``cnet.*``, ``update_block.*``; the cnet's
BatchNorms keep ``running_mean`` / ``running_var`` and run frozen), so a
``raft-things.pth`` loads directly once its DataParallel ``module.``
prefix is stripped. The JAX package has no Pallas kernel here, and
neither has the port: convolutions go to cuDNN, the all-pairs correlation
is one batched product, the pyramid lookup a gather.

  * ``correlation_pyramid``: the (B*H*W, H, W) volume of every pixel of
    image 1 against every pixel of image 2, average-pooled per level;
  * ``corr_lookup``: a (2r+1)^2 bilinear neighbourhood at every level,
    the x offset varying with the MAJOR index of the offset grid (the
    original RAFT's order, which its pretrained ``convc1`` expects);
  * ``convex_upsample``: the 8x convex combination of 3x3 neighbours;
  * ``RAFT``: images (B, H, W, 3) in [-1, 1], H and W multiples of 8 ->
    forward flow (B, H, W, 2) = (u, v), 12 GRU iterations in a Python loop
    with only the last iteration's upsampling mask computed.

Tracing (``utils/tracing.py``): a forward opens ``raft.encode`` (fnet and
cnet), ``raft.corr`` (the pyramid), ``raft.lookup`` and ``raft.update``
(each iteration's lookup, and its motion encoder, GRU and flow head) and
``raft.upsample``; ``RAFT.pairs`` counts the (image1, image2) pairs run,
as the kernel wrappers count their ``.launches``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from insv2v_torch.utils.tracing import span

__all__ = ["RaftConfig", "RAFT", "correlation_pyramid", "corr_lookup", "convex_upsample"]


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    feature_dim: int = 256
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    base_width: int = 64

    @classmethod
    def tiny(cls) -> "RaftConfig":
        return cls(feature_dim=32, hidden_dim=16, context_dim=16, corr_levels=2,
                   corr_radius=2, iters=3, base_width=8)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class _InstanceNorm(nn.Module):
    """InstanceNorm2d without affine or running statistics (no parameters)."""

    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


def _norm(kind: str, c: int) -> nn.Module:
    return _InstanceNorm() if kind == "instance" else FrozenBatchNorm2d(c)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm, planes), _norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            # princeton-vl registers norm3 twice (as norm3 and downsample.1)
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """conv 7x7/2 -> three residual stages (/1, /2, /2) -> 1x1 head: features
    at 1/8 resolution, NCHW."""

    def __init__(self, output_dim: int, norm: str, base: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, base, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, base)
        cin = base
        for li, (planes, stride) in enumerate(zip((base, base * 3 // 2, base * 2), (1, 2, 2)),
                                              start=1):
            setattr(self, f"layer{li}", nn.Sequential(ResidualBlock(cin, planes, norm, stride),
                                                      ResidualBlock(planes, planes, norm)))
            cin = planes
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """All-pairs correlation of f1, f2 (B, H, W, D) -> ``levels`` volumes
    (B*H*W, H/2^l, W/2^l), float32. Each level average-pools the last with
    floor semantics; a 1-wide axis keeps a pool size of 1."""
    b, h, w, d = f1.shape
    corr = torch.bmm(f1.float().reshape(b, h * w, d), f2.float().reshape(b, h * w, d).transpose(1, 2))
    corr = (corr / math.sqrt(d)).reshape(b * h * w, 1, h, w)
    pyr = [corr]
    for _ in range(levels - 1):
        c = pyr[-1]
        kh, kw = (2 if c.shape[2] >= 2 else 1), (2 if c.shape[3] >= 2 else 1)
        pyr.append(F.avg_pool2d(c, (kh, kw), stride=(kh, kw)))
    return tuple(p[:, 0] for p in pyr)


def _bilinear_gather(vol: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """vol (N, H, W); ys, xs (N, K) sample positions -> (N, K). Each of the
    four corners is zeroed on its own when it falls outside."""
    n, h, w = vol.shape
    flat_vol = vol.reshape(n, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0

    def at(yi, xi):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        flat = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.gather(flat_vol, 1, flat) * inb.to(vol.dtype)

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 neighbourhoods around ``coords`` (B, H, W, 2) = (x, y) at
    1/8 resolution, at every level -> (B, H, W, levels*(2r+1)^2). Channel
    ``a*(2r+1) + b`` of a level samples offset (x, y) = (a - r, b - r)."""
    b, h, w, _ = coords.shape
    n = b * h * w
    offs = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    major, minor = torch.meshgrid(offs, offs, indexing="ij")
    offs_x, offs_y = major.reshape(1, -1), minor.reshape(1, -1)
    cx = coords[..., 0].reshape(n, 1).float()
    cy = coords[..., 1].reshape(n, 1).float()
    outs = [_bilinear_gather(vol, cy * 0.5 ** lvl + offs_y, cx * 0.5 ** lvl + offs_x)
            for lvl, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).reshape(b, h, w, -1)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (B, h, w, 2), mask (B, h, w, 64*9) -> flow (B, 8h, 8w, 2): each
    fine pixel (u, v) of a coarse cell is a softmax-weighted mix of the 3x3
    coarse neighbours (row-major, zero-padded) of 8 x flow. The mask's
    channel ``(u*8 + v)*9 + n`` weighs neighbour n."""
    b, h, w, _ = flow.shape
    weights = torch.softmax(mask.float().reshape(b, h, w, 8, 8, 9), dim=-1)
    pad = F.pad(flow.float() * 8.0, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3)],
                        dim=-2)  # (B, h, w, 9, 2)
    up = torch.einsum("bhwuvn,bhwne->bhwuve", weights, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 126, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    """A horizontal (1x5) then a vertical (5x1) convolutional GRU."""

    def __init__(self, hidden: int, inp: int):
        super().__init__()
        for s, (ks, pad) in (("1", ((1, 5), (0, 2))), ("2", ((5, 1), (2, 0)))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", nn.Conv2d(hidden + inp, hidden, ks, padding=pad))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    """One refinement: motion features from flow and correlation, the GRU,
    the flow delta; ``upsample_mask`` gives the convex-upsampling weights."""

    def __init__(self, cfg: RaftConfig):
        super().__init__()
        self.encoder = MotionEncoder(cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128)
        self.flow_head = FlowHead(cfg.hidden_dim)
        self.mask = nn.Sequential(nn.Conv2d(cfg.hidden_dim, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, h, context, corr, flow):
        h = self.gru(h, torch.cat([context, self.encoder(flow, corr)], dim=1))
        return h, self.flow_head(h)

    def upsample_mask(self, h):
        return 0.25 * self.mask(h)


class RAFT(nn.Module):
    """image1, image2 (B, H, W, 3) in [-1, 1], H and W multiples of 8 ->
    forward flow (B, H, W, 2) from image1 to image2, float32."""

    pairs = 0  # (image1, image2) pairs run by any RAFT of the process

    def __init__(self, cfg: RaftConfig = RaftConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg.feature_dim, "instance", cfg.base_width)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch", cfg.base_width)
        self.update_block = UpdateBlock(cfg)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        iters = iters or cfg.iters
        nchw = lambda t: t.permute(0, 3, 1, 2)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        b, hh, ww, _ = image1.shape
        RAFT.pairs += b
        h, w = hh // 8, ww // 8
        with span("raft.encode"):
            f1, f2 = self.fnet(nchw(torch.cat([image1, image2], dim=0))).chunk(2, dim=0)
            cmap = self.cnet(nchw(image1))
            hidden = torch.tanh(cmap[:, : cfg.hidden_dim])
            context = F.relu(cmap[:, cfg.hidden_dim:])
        with span("raft.corr"):
            pyramid = correlation_pyramid(nhwc(f1), nhwc(f2), cfg.corr_levels)
        gy, gx = torch.meshgrid(torch.arange(h, device=image1.device, dtype=torch.float32),
                                torch.arange(w, device=image1.device, dtype=torch.float32),
                                indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)
        flow = image1.new_zeros((b, h, w, 2), dtype=torch.float32)
        for _ in range(iters):
            with span("raft.lookup"):
                corr = corr_lookup(pyramid, coords0 + flow, cfg.corr_radius)
            with span("raft.update"):
                hidden, delta = self.update_block(hidden, context, nchw(corr), nchw(flow))
                flow = flow + nhwc(delta).float()
        with span("raft.upsample"):
            return convex_upsample(flow, nhwc(self.update_block.upsample_mask(hidden)))
