"""SD KL autoencoder (CompVis ldm backbone) as torch modules, channels-last.

Counterpart of ``models/vae.py`` in the JAX package, with the reference's
state-dict layout (``encoder.down.0.block.1.conv1.weight``,
``decoder.mid.attn_1.q.weight``, ``quant_conv``...). Images are
(N, H, W, 3) in [-1, 1], latents (N, H/8, W/8, embed_dim). The mid-block
``AttnBlock`` is single-head self-attention with d = C = 512 over H*W
positions and goes through ``dot_attention`` (kernel A at >= 256
positions). ``Downsample`` keeps the asymmetric (0, 1) pad.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from insv2v_torch.models.unet3d import GroupNorm, conv2d_frames, linear_1x1
from insv2v_torch.ops.attention import dot_attention
from insv2v_torch.ops.resize import nearest_upsample_2x

__all__ = ["VaeConfig", "AutoencoderKL", "DiagonalGaussian", "SD_SCALE_FACTOR"]

SD_SCALE_FACTOR = 0.18215  # configs/instruct_v2v.yaml trainer.scale_factor


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    """configs/instruct_v2v.yaml ``vae.params.ddconfig``."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    resolution: int = 256
    double_z: bool = True


def _norm(c: int) -> GroupNorm:
    return GroupNorm(min(32, c), c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = conv2d_frames(self.conv1, self.norm1(x, silu=True))
        h = conv2d_frames(self.conv2, self.norm2(h, silu=True))
        if self.nin_shortcut is not None:
            x = linear_1x1(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over all positions of the image."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        n, hh, ww, c = x.shape
        h = self.norm(x)
        seq = lambda conv: linear_1x1(conv, h).reshape(n, 1, hh * ww, c)
        o = dot_attention(seq(self.q), seq(self.k), seq(self.v)).reshape(n, hh, ww, c)
        return x + linear_1x1(self.proj_out, o)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return conv2d_frames(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return conv2d_frames(self.conv, nearest_upsample_2x(x))


class Encoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in, res = cfg.ch, cfg.resolution
        for i, mult in enumerate(cfg.ch_mult):
            lvl = nn.Module()
            lvl.block = nn.ModuleList()
            lvl.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlock(block_in, cfg.ch * mult))
                block_in = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    lvl.attn.append(AttnBlock(block_in))
            if i != len(cfg.ch_mult) - 1:
                lvl.downsample = Downsample(block_in)
                res //= 2
            self.down.append(lvl)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = _norm(block_in)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, zc, 3, padding=1)

    def forward(self, x):
        h = conv2d_frames(self.conv_in, x)
        for lvl in self.down:
            for i, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[i](h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return conv2d_frames(self.conv_out, self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        ups = []
        for i in reversed(range(len(cfg.ch_mult))):
            lvl = nn.Module()
            lvl.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                lvl.block.append(ResnetBlock(block_in, cfg.ch * cfg.ch_mult[i]))
                block_in = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                lvl.upsample = Upsample(block_in)
            ups.insert(0, lvl)
        self.up = nn.ModuleList(ups)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = conv2d_frames(self.conv_in, z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return conv2d_frames(self.conv_out, self.norm_out(h, silu=True))


class DiagonalGaussian:
    """The posterior; ``sample`` takes its standard normals from outside."""

    def __init__(self, moments: torch.Tensor):
        mean, logvar = moments.float().chunk(2, dim=-1)
        self.mean = mean
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        return self.mean + self.std * eps.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VaeConfig = VaeConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def posterior(self, x: torch.Tensor) -> DiagonalGaussian:
        dt = self.quant_conv.weight.dtype
        return DiagonalGaussian(linear_1x1(self.quant_conv, self.encoder(x.to(dt))))

    def encode(self, x: torch.Tensor, eps=None) -> torch.Tensor:
        """Sampled latent (f32) with standard normals ``eps`` of the
        latent's shape; the posterior mean when ``eps`` is None."""
        post = self.posterior(x)
        return post.mode() if eps is None else post.sample(eps)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.post_quant_conv.weight.dtype
        return self.decoder(linear_1x1(self.post_quant_conv, z.to(dt)))
