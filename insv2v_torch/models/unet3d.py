"""UNet3DConditionModel: the SD-1.5 UNet inflated to video, with
AnimateDiff motion modules, as torch modules over ``(B, F, H, W, C)``.

Counterpart of ``models/unet3d.py`` in the JAX package; module and
parameter names follow the reference's torch state dict
(``down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.weight``,
``...motion_modules.0.temporal_transformer...``), so a real checkpoint
loads as it is. The stream stays channels-last; convolutions see
``(B*F, C, H, W)`` views of it in channels-last memory (no copies), and
1x1 convolutions run as ``F.linear`` on the channels-last stream.

GroupNorm statistics: ``ResnetBlock3D`` pools ACROSS frames, the spatial
transformer and the motion module per frame (eps 1e-6). Every spatial
and motion FF goes through ``geglu_ff`` (kernel B); the spatial
self-attention through ``dot_attention`` (kernel A at S >= 256); the
motion modules' attention over frames through ``temporal_attention``
(kernel C) on the unpacked per-(pixel, head) F x F form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from insv2v_torch.ops.attention import dot_attention_bshd, temporal_attention
from insv2v_torch.ops.embeddings import (
    temporal_pe_slice,
    temporal_positional_encoding_table,
    timestep_embedding,
)
from insv2v_torch.ops.fused_ff import geglu_ff
from insv2v_torch.ops.norms import group_norm, layer_norm
from insv2v_torch.ops.resize import nearest_upsample_2x

__all__ = ["UNetConfig", "UNet3DConditionModel"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """configs/instruct_v2v.yaml ``unet.params``."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
        "DownBlock3D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D")
    layers_per_block: int = 2
    attention_head_dim: int = 8  # = number of heads (diffusers naming)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_num_attention_heads: int = 8
    motion_num_transformer_block: int = 1
    motion_attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    motion_max_seq_length: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # recompute each Down/Mid/Up block's activations in the backward
    # instead of keeping them (the JAX package's nn.remat on the blocks)
    remat: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def tiny(cls, **kw) -> "UNetConfig":
        """The JAX package's fixture-sized config, for CPU tests."""
        defaults = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                        cross_attention_dim=12, norm_num_groups=4,
                        motion_num_attention_heads=2, motion_max_seq_length=8)
        defaults.update(kw)
        return cls(**defaults)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters, applied channels-last through
    ``ops.norms.group_norm``; ``reduce_axes`` as there."""

    def forward(self, x, reduce_axes=None):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          reduce_axes=reduce_axes)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def _norm(groups: int, c: int, eps: float) -> GroupNorm:
    return GroupNorm(min(groups, c), c, eps=eps)


def conv2d_frames(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 2D conv over (B, F, H, W, C) with (B, F) as one batch axis. The
    NCHW view of the channels-last stream is channels-last in memory, so
    cuDNN runs NHWC and the result comes back as a view."""
    lead = x.shape[:-3]
    xf = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    y = conv(xf).permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def linear_1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on the channels-last stream, as the linear map it is."""
    return F.linear(x, conv.weight.reshape(conv.weight.shape[:2]), conv.bias)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class CrossAttention(nn.Module):
    """diffusers ``Attention``: to_q/k/v without bias, to_out.0 with bias."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash: Optional[bool] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.use_flash = use_flash
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x, context=None):
        context = x if context is None else context
        o = dot_attention_bshd(self.to_q(x), self.to_k(context), self.to_v(context),
                               self.heads, use_flash=self.use_flash)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """diffusers GEGLU FeedForward (``ff.net.0.proj``, ``ff.net.2``); its
    forward is kernel B's fused LN + FF + residual, see ``residual``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def residual(self, x, norm: nn.LayerNorm):
        """``x + FF(norm(x))`` in one call of ``geglu_ff``."""
        return geglu_ff(x, norm.weight, norm.bias, self.net[0].proj.weight,
                        self.net[0].proj.bias, self.net[2].weight, self.net[2].bias,
                        eps=norm.eps)


class BasicTransformerBlock(nn.Module):
    """Spatial: self-attn + text cross-attn + GEGLU FF."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim, use_flash=False)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return self.ff.residual(x, self.norm3)


class Transformer3DModel(nn.Module):
    """Per-frame spatial transformer. x (B, F, H, W, C), context (B, L, D)."""

    def __init__(self, c: int, heads: int, head_dim: int, groups: int, context_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.norm = _norm(groups, c, 1e-6)
        self.proj_in = nn.Conv2d(c, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim)])
        self.proj_out = nn.Conv2d(inner, c, 1)

    def forward(self, x, context):
        b, f, h, w, c = x.shape
        xf = self.norm(x.reshape(b * f, h, w, c))  # per-frame statistics
        seq = linear_1x1(self.proj_in, xf).reshape(b * f, h * w, -1)
        ctx = context.repeat_interleave(f, dim=0)
        seq = self.transformer_blocks[0](seq, ctx)
        out = linear_1x1(self.proj_out, seq)
        return out.reshape(b, f, h, w, c) + x


class VersatileAttention(CrossAttention):
    """Temporal self-attention with the sinusoidal PE, on the (B, P, F, C)
    stream: frames attended, each (pixel, head) on its own."""

    def __init__(self, dim: int, heads: int, head_dim: int, max_len: int):
        super().__init__(dim, heads, head_dim)
        self.head_dim = head_dim
        pe = torch.from_numpy(temporal_positional_encoding_table(dim, max_len))
        # regenerated from (dim, max_len), so kept out of the state dict
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x, video_start_index: int):
        b, p, f, c = x.shape
        x = x + temporal_pe_slice(self.pe, video_start_index, f).to(x)
        split = lambda t: t.reshape(b, p, f, self.heads, self.head_dim)
        o = temporal_attention(split(self.to_q(x)), split(self.to_k(x)),
                               split(self.to_v(x)), self.head_dim ** -0.5)
        return self.to_out[0](o.reshape(b, p, f, c))


class TemporalTransformerBlock(nn.Module):
    """2x (LN + temporal self-attn) + LN + FF."""

    def __init__(self, dim: int, heads: int, n_attn: int, max_len: int):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            [VersatileAttention(dim, heads, dim // heads, max_len) for _ in range(n_attn)])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, x, video_start_index: int):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = x + attn(norm(x), video_start_index)
        return self.ff.residual(x, self.ff_norm)


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, c: int, heads: int, n_blocks: int, block_types, max_len: int,
                 groups: int):
        super().__init__()
        assert all(t == "Temporal_Self" for t in block_types), block_types
        self.norm = _norm(groups, c, 1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(c, heads, len(block_types), max_len)
             for _ in range(n_blocks)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, video_start_index: int):
        b, f, h, w, c = x.shape
        xf = self.norm(x.reshape(b * f, h, w, c))  # per-frame statistics
        seq = self.proj_in(xf.reshape(b, f, h * w, c))
        # the motion stream lives as (B, P, F, C): one relayout in and one
        # out, and q/k/v come out of their projections already in kernel
        # C's (B, P, F, heads, e) layout
        seq = seq.transpose(1, 2).contiguous()
        for blk in self.transformer_blocks:
            seq = blk(seq, video_start_index)
        seq = self.proj_out(seq).transpose(1, 2)
        return seq.reshape(b, f, h, w, c) + x


class MotionModule(nn.Module):
    """AnimateDiff VanillaTemporalModule; proj_out starts at zero."""

    def __init__(self, c: int, cfg: UNetConfig):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(
            c, cfg.motion_num_attention_heads, cfg.motion_num_transformer_block,
            cfg.motion_attention_block_types, cfg.motion_max_seq_length,
            cfg.norm_num_groups)
        nn.init.zeros_(self.temporal_transformer.proj_out.weight)
        nn.init.zeros_(self.temporal_transformer.proj_out.bias)

    def forward(self, x, video_start_index: int):
        return self.temporal_transformer(x, video_start_index)


class ResnetBlock3D(nn.Module):
    """GN (across frames) -> SiLU -> conv -> +temb -> GN -> SiLU -> conv,
    1x1 shortcut on a channel change."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = _norm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = _norm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        h = conv2d_frames(self.conv1, F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = conv2d_frames(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = linear_1x1(self.conv_shortcut, x)
        return x + h


class Downsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return conv2d_frames(self.conv, x)


class Upsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return conv2d_frames(self.conv, nearest_upsample_2x(x))


class DownBlock3D(nn.Module):
    def __init__(self, cfg: UNetConfig, cin: int, cout: int, cross: bool,
                 motion: bool, downsample: bool):
        super().__init__()
        n = cfg.layers_per_block
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock3D(cin if i == 0 else cout, cout, temb, cfg.norm_num_groups,
                          cfg.norm_eps) for i in range(n)])
        heads = cfg.attention_head_dim
        self.attentions = nn.ModuleList([
            Transformer3DModel(cout, heads, cout // heads, cfg.norm_num_groups,
                               cfg.cross_attention_dim) for _ in range(n)]) if cross else None
        self.motion_modules = nn.ModuleList(
            [MotionModule(cout, cfg) for _ in range(n)]) if motion else None
        self.downsamplers = nn.ModuleList([Downsample3D(cout)]) if downsample else None

    def forward(self, x, temb, context, video_start_index):
        states = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, video_start_index)
            states.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class MidBlock3D(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        temb = cfg.time_embed_dim
        heads = cfg.attention_head_dim
        self.resnets = nn.ModuleList([
            ResnetBlock3D(ch, ch, temb, cfg.norm_num_groups, cfg.norm_eps)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(ch, heads, ch // heads, cfg.norm_num_groups,
                               cfg.cross_attention_dim)])
        self.motion_modules = (nn.ModuleList([MotionModule(ch, cfg)])
                               if cfg.use_motion_module and cfg.motion_module_mid_block
                               else None)

    def forward(self, x, temb, context, video_start_index):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        if self.motion_modules is not None:
            x = self.motion_modules[0](x, video_start_index)
        return self.resnets[1](x, temb)


class UpBlock3D(nn.Module):
    def __init__(self, cfg: UNetConfig, prev: int, cout: int, skip_in: int,
                 cross: bool, motion: bool, upsample: bool):
        super().__init__()
        n = cfg.layers_per_block + 1
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock3D((prev if i == 0 else cout) + (skip_in if i == n - 1 else cout),
                          cout, temb, cfg.norm_num_groups, cfg.norm_eps)
            for i in range(n)])
        heads = cfg.attention_head_dim
        self.attentions = nn.ModuleList([
            Transformer3DModel(cout, heads, cout // heads, cfg.norm_num_groups,
                               cfg.cross_attention_dim) for _ in range(n)]) if cross else None
        self.motion_modules = nn.ModuleList(
            [MotionModule(cout, cfg) for _ in range(n)]) if motion else None
        self.upsamplers = nn.ModuleList([Upsample3D(cout)]) if upsample else None

    def forward(self, x, skips, temb, context, video_start_index):
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, skip=skips.pop())
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, video_start_index)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet3DConditionModel(nn.Module):
    """sample (B, F, H, W, C_in), timesteps (B,) or scalar, context
    (B, L, D_text), window start index -> eps (B, F, H, W, C_out), in the
    parameters' dtype."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        motion = lambda res: cfg.use_motion_module and res in cfg.motion_module_resolutions
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            self.down_blocks.append(DownBlock3D(
                cfg, cin, ch[i], kind == "CrossAttnDownBlock3D", motion(2 ** i),
                downsample=i < len(ch) - 1))
            cin = ch[i]
        self.mid_block = MidBlock3D(cfg)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            self.up_blocks.append(UpBlock3D(
                cfg, prev, rev[i], rev[min(i + 1, len(ch) - 1)],
                kind == "CrossAttnUpBlock3D", motion(2 ** (len(ch) - 1 - i)),
                upsample=i < len(ch) - 1))
            prev = rev[i]
        self.conv_norm_out = _norm(cfg.norm_num_groups, ch[0], cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def _block(self, blk, *args):
        """One block, under activation checkpointing when ``cfg.remat`` and
        a gradient is being recorded: the backward reruns its forward,
        kernel launches included, rather than keep its activations."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def forward(self, sample, timesteps, encoder_hidden_states, video_start_index: int = 0):
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        if not torch.is_tensor(timesteps) or timesteps.ndim == 0:
            timesteps = torch.as_tensor(timesteps, device=sample.device).expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dt)
        temb = self.time_embedding(t_emb)
        context = encoder_hidden_states.to(dt)
        x = conv2d_frames(self.conv_in, sample.to(dt))
        skips = [x]
        for blk in self.down_blocks:
            x, states = self._block(blk, x, temb, context, video_start_index)
            skips.extend(states)
        x = self._block(self.mid_block, x, temb, context, video_start_index)
        n_res = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            block_skips = skips[-n_res:]
            del skips[-n_res:]
            x = self._block(blk, x, block_skips, temb, context, video_start_index)
        x = F.silu(self.conv_norm_out(x))
        return conv2d_frames(self.conv_out, x)
