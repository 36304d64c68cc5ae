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

SDXL-shaped configurations (``configs/insv2v_sdxl.yaml``): heads given per
level (``attention_head_dim`` as a tuple, diffusers' naming), a
transformer depth per level (``transformer_layers_per_block``; the mid
block takes the last level's), linear ``proj_in``/``proj_out``
(``use_linear_projection``) and the ``text_time`` added embedding
(``addition_embed_type``): the pooled text embedding and six size ids,
each id sinusoidal at ``addition_time_embed_dim``, through a linear,
SiLU and a linear into the time embedding. A call hands them in as
``added_cond = {"text_embeds": (B, D), "time_ids": (B, 6)}``. A spatial
transformer of more than one block (a stack) runs inside the span
``unet.stack.l<level>``.

Split skip (``INSV2V_SPLIT_SKIP``, the JAX package's switch and default:
on for calls of at most ``INSV2V_SPLIT_SKIP_MAX_B`` = 3 videos, such as
the edit's 3x-CFG call): each up-block ResnetBlock3D consumes its skip
without building ``concat([x, skip], -1)``. That concat feeds only norm1,
conv1 and conv_shortcut: norm1's statistics compose from per-part moments
(``ops.norms.group_norm_split_pair``), and a convolution of a channel
concat is the sum of the convolutions with the kernel sliced along its
input channels. Same math and the same parameters as the concat path;
``UNetConfig.split_skip`` overrides the switch.

Frame-sharded (inside ``parallel.dist.frame_parallel``; the JAX package's
``INSV2V_SP_AXIS``): each rank holds a contiguous share of the frames; the
across-frame GroupNorms all-reduce their moments, and each motion module
exchanges frame shards for pixel shards after ``proj_in`` (one all-to-all)
so the rank runs its blocks on its pixels over all F frames, and back
before ``proj_out``. Everything else is frame-local.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping, Optional, Tuple, Union

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
from insv2v_torch.ops.norms import group_norm, group_norm_split_pair, layer_norm
from insv2v_torch.ops.resize import nearest_upsample_2x
from insv2v_torch.parallel.dist import frame_group
from insv2v_torch.utils.tracing import span

__all__ = ["UNetConfig", "UNet3DConditionModel", "uses_split_skip"]

# the split-skip path (module docstring): the JAX package's switches and
# defaults, read when a call decides (``uses_split_skip``). On by default:
# on an NVIDIA H100 80GB HBM3 at 700 W one UNet call of the edit is 86.72 ms
# of device time split, 86.22 ms concat (+0.57 %, within the 1 % that keeps
# the JAX default; chip_smoke.py's split phase, PERF.md)
SPLIT_SKIP = os.environ.get("INSV2V_SPLIT_SKIP", "1") == "1"
SPLIT_SKIP_MAX_B = int(os.environ.get("INSV2V_SPLIT_SKIP_MAX_B", "3"))


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """configs/instruct_v2v.yaml ``unet.params`` (and configs/insv2v_sdxl.yaml's)."""

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
    # number of heads (diffusers naming): one for every level, or one a level
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    # spatial transformer blocks: one for every level, or one a level (the
    # mid block takes the last level's)
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    cross_attention_dim: int = 768
    use_linear_projection: bool = False  # proj_in/proj_out as Linear, else 1x1 conv
    # "text_time": the pooled text embedding and the size ids added to temb
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
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
    # the up blocks' split-skip path: None follows INSV2V_SPLIT_SKIP (the
    # trainer's calls pin False, as the JAX trainer does)
    split_skip: Optional[bool] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads(self, level: int) -> int:
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[level]

    def depth(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return d if isinstance(d, int) else d[level]

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
    ``ops.norms.group_norm``; ``reduce_axes`` and ``silu`` as there. On the
    5D video stream its statistics pool across frames, so under a frame
    group they come from every rank's frames."""

    def forward(self, x, reduce_axes=None, silu: bool = False):
        group = frame_group() if x.ndim == 5 and reduce_axes is None else None
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          reduce_axes=reduce_axes, group=group, silu=silu)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def _norm(groups: int, c: int, eps: float) -> GroupNorm:
    return GroupNorm(min(groups, c), c, eps=eps)


def conv2d_frames(conv: nn.Conv2d, x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 2D conv over (B, F, H, W, C) with (B, F) as one batch axis. The
    NCHW view of the channels-last stream is channels-last in memory, so
    cuDNN runs NHWC and the result comes back as a view. ``weight`` (with
    ``bias``) stands in for the conv's own, with its stride and padding."""
    lead = x.shape[:-3]
    xf = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    y = conv(xf) if weight is None else F.conv2d(xf, weight, bias, conv.stride, conv.padding,
                                                conv.dilation, conv.groups)
    y = y.permute(0, 2, 3, 1)
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


def _project(proj: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A transformer's proj_in/proj_out on the channels-last stream."""
    return proj(x) if isinstance(proj, nn.Linear) else linear_1x1(proj, x)


class Transformer3DModel(nn.Module):
    """Per-frame spatial transformer of ``depth`` blocks. x (B, F, H, W, C),
    context (B, L, D). A stack (depth > 1) runs inside the span
    ``unet.stack.l<level>``."""

    def __init__(self, c: int, heads: int, head_dim: int, groups: int, context_dim: int,
                 depth: int = 1, linear: bool = False, level: int = 0):
        super().__init__()
        inner = heads * head_dim
        self.norm = _norm(groups, c, 1e-6)
        self.proj_in = nn.Linear(c, inner) if linear else nn.Conv2d(c, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(inner, c) if linear else nn.Conv2d(inner, c, 1)
        self.span_name = f"unet.stack.l{level}" if depth > 1 else None

    def forward(self, x, context):
        if self.span_name is None:
            return self._forward(x, context)
        with span(self.span_name):
            return self._forward(x, context)

    def _forward(self, x, context):
        b, f, h, w, c = x.shape
        xf = self.norm(x.reshape(b * f, h, w, c))  # per-frame statistics
        seq = _project(self.proj_in, xf).reshape(b * f, h * w, -1)
        ctx = context.repeat_interleave(f, dim=0)
        for blk in self.transformer_blocks:
            seq = blk(seq, ctx)
        out = _project(self.proj_out, seq)
        return out.reshape(b, f, h, w, c) + x


def _transformer(cfg: "UNetConfig", c: int, level: int) -> Transformer3DModel:
    """The spatial transformer of a block at ``level``, as ``cfg`` shapes it."""
    heads = cfg.heads(level)
    return Transformer3DModel(c, heads, c // heads, cfg.norm_num_groups, cfg.cross_attention_dim,
                              cfg.depth(level), cfg.use_linear_projection, level)


def _pe_table(dim: int, max_len: int, device=None) -> torch.Tensor:
    """The sinusoidal PE table on ``device`` (default: the ambient one)."""
    return torch.tensor(temporal_positional_encoding_table(dim, max_len), device=device)


def _pe_to_weights_device(module: "VersatileAttention", _incompatible) -> None:
    """After a state-dict load, the PE table is made anew where the weights
    are: a module built on the meta device, then handed its weights with
    ``assign=True``, would keep a meta table."""
    device = module.to_q.weight.device
    if module.pe.device != device:
        max_len, dim = module.pe.shape
        module.pe = _pe_table(dim, max_len, device)


class VersatileAttention(CrossAttention):
    """Temporal self-attention with the sinusoidal PE, on the (B, P, F, C)
    stream: frames attended, each (pixel, head) on its own."""

    def __init__(self, dim: int, heads: int, head_dim: int, max_len: int):
        super().__init__(dim, heads, head_dim)
        self.head_dim = head_dim
        # regenerated from (dim, max_len), so kept out of the state dict
        self.register_buffer("pe", _pe_table(dim, max_len), persistent=False)
        self.register_load_state_dict_post_hook(_pe_to_weights_device)

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
        group = frame_group()
        if group is not None:
            # frames sharded: exchange frame shards for pixel shards, so
            # this rank runs the blocks on its pixels over all F frames
            seq = group.all_to_all_dims(seq, split_dim=2, cat_dim=1)
        # the motion stream lives as (B, P, F, C): one relayout in and one
        # out, and q/k/v come out of their projections already in kernel
        # C's (B, P, F, heads, e) layout
        seq = seq.transpose(1, 2).contiguous()
        for blk in self.transformer_blocks:
            seq = blk(seq, video_start_index)
        seq = self.proj_out(seq).transpose(1, 2)
        if group is not None:  # and back: this rank's frames, every pixel
            pixels = [len(r) for r in torch.arange(h * w).tensor_split(group.size)]
            seq = group.all_to_all_dims(seq, split_dim=1, cat_dim=2, cat_sizes=pixels)
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


def _kernel_parts(w: torch.Tensor, c1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv kernel sliced along its input channels at ``c1``. cuDNN's
    channels-last convolution copies a kernel that is not channels-last
    contiguous at every call, and a slice never is: without gradients the
    two parts are made channels-last once and kept on the kernel while it
    is unchanged (``load_state_dict``, an optimizer step or a cast bump its
    version or move its storage; a write through ``.data`` does neither).
    On an NVIDIA H100 80GB HBM3 at 700 W the 12 up-block conv1s of one
    edit UNet call take 4.951 ms of device time on the slices as stored,
    4.415 on kept ones (chip_smoke.py's split phase)."""
    if torch.is_grad_enabled() and w.requires_grad:
        return w[:, :c1], w[:, c1:]
    key = (w._version, w.data_ptr(), c1)
    hit = getattr(w, "_split_parts", None)
    if hit is None or hit[0] != key:
        cl = torch.channels_last
        hit = w._split_parts = (key, (w[:, :c1].contiguous(memory_format=cl),
                                      w[:, c1:].contiguous(memory_format=cl)))
    return hit[1]


def uses_split_skip(cfg: UNetConfig, batch: int, split_skip: Optional[bool] = None) -> bool:
    """Whether a call of ``batch`` videos takes the split-skip path: the
    JAX rule, the call's ``split_skip``, else ``cfg.split_skip``, else
    ``SPLIT_SKIP``, and at most ``SPLIT_SKIP_MAX_B`` videos."""
    enabled = next((e for e in (split_skip, cfg.split_skip) if e is not None), SPLIT_SKIP)
    return enabled and batch <= SPLIT_SKIP_MAX_B


class ResnetBlock3D(nn.Module):
    """GN (across frames) -> SiLU -> conv -> +temb -> GN -> SiLU -> conv,
    1x1 shortcut on a channel change. An up block's ``skip`` is
    concatenated on the channel axis, or with ``split`` consumed part by
    part (the module docstring's split-skip path)."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = _norm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = _norm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, skip=None, split: bool = False):
        if skip is not None and split:
            return self._split_forward(x, temb, skip)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        h = conv2d_frames(self.conv1, self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = conv2d_frames(self.conv2, self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = linear_1x1(self.conv_shortcut, x)
        return x + h

    def _split_forward(self, x, temb, skip):
        """The concat path's math on the parts: norm1 from the parts'
        combined moments, conv1 and conv_shortcut as sums over the parts
        with their kernels sliced along the input channels (bias once)."""
        c1 = x.shape[-1]
        assert self.conv_shortcut is not None, "the split path expects a channel change"
        norm1 = self.norm1
        xn, sn = group_norm_split_pair(x, skip, norm1.weight, norm1.bias, norm1.num_groups,
                                       norm1.eps, group=frame_group(), silu=True)
        wx, ws = _kernel_parts(self.conv1.weight, c1)
        h = (conv2d_frames(self.conv1, xn, wx, self.conv1.bias)
             + conv2d_frames(self.conv1, sn, ws))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = conv2d_frames(self.conv2, self.norm2(h, silu=True))
        w1 = self.conv_shortcut.weight.reshape(self.conv_shortcut.weight.shape[:2])
        return F.linear(x, w1[:, :c1], self.conv_shortcut.bias) + F.linear(skip, w1[:, c1:]) + h


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
                 motion: bool, downsample: bool, level: int = 0):
        super().__init__()
        n = cfg.layers_per_block
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock3D(cin if i == 0 else cout, cout, temb, cfg.norm_num_groups,
                          cfg.norm_eps) for i in range(n)])
        self.attentions = nn.ModuleList(
            [_transformer(cfg, cout, level) for _ in range(n)]) if cross else None
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
        self.resnets = nn.ModuleList([
            ResnetBlock3D(ch, ch, temb, cfg.norm_num_groups, cfg.norm_eps)
            for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, ch, len(cfg.block_out_channels) - 1)])
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
                 cross: bool, motion: bool, upsample: bool, level: int = 0):
        super().__init__()
        n = cfg.layers_per_block + 1
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock3D((prev if i == 0 else cout) + (skip_in if i == n - 1 else cout),
                          cout, temb, cfg.norm_num_groups, cfg.norm_eps)
            for i in range(n)])
        self.attentions = nn.ModuleList(
            [_transformer(cfg, cout, level) for _ in range(n)]) if cross else None
        self.motion_modules = nn.ModuleList(
            [MotionModule(cout, cfg) for _ in range(n)]) if motion else None
        self.upsamplers = nn.ModuleList([Upsample3D(cout)]) if upsample else None

    def forward(self, x, skips, temb, context, video_start_index, split: bool = False):
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, skip=skips.pop(), split=split)
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
    parameters' dtype. A call's ``split_skip`` overrides
    ``cfg.split_skip``; ``added_cond`` carries the ``text_time`` inputs
    where the configuration has them."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   cfg.time_embed_dim)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r} unknown")
        motion = lambda res: cfg.use_motion_module and res in cfg.motion_module_resolutions
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            self.down_blocks.append(DownBlock3D(
                cfg, cin, ch[i], kind == "CrossAttnDownBlock3D", motion(2 ** i),
                downsample=i < len(ch) - 1, level=i))
            cin = ch[i]
        self.mid_block = MidBlock3D(cfg)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            self.up_blocks.append(UpBlock3D(
                cfg, prev, rev[i], rev[min(i + 1, len(ch) - 1)],
                kind == "CrossAttnUpBlock3D", motion(2 ** (len(ch) - 1 - i)),
                upsample=i < len(ch) - 1, level=len(ch) - 1 - i))
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

    def text_time_embedding(self, added_cond: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(B, D + 6 * addition_time_embed_dim): the pooled text embedding,
        then each size id's sinusoidal embedding (diffusers' ``text_time``)."""
        ids = added_cond["time_ids"]
        t = timestep_embedding(ids.flatten(), self.cfg.addition_time_embed_dim,
                               self.cfg.flip_sin_to_cos, self.cfg.freq_shift)
        pooled = added_cond["text_embeds"]
        return torch.cat([pooled.float(), t.reshape(ids.shape[0], -1)], dim=-1)

    def forward(self, sample, timesteps, encoder_hidden_states, video_start_index: int = 0,
                split_skip: Optional[bool] = None,
                added_cond: Optional[Mapping[str, torch.Tensor]] = None):
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        if not torch.is_tensor(timesteps) or timesteps.ndim == 0:
            timesteps = torch.as_tensor(timesteps, device=sample.device).expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dt)
        temb = self.time_embedding(t_emb)
        if cfg.addition_embed_type is not None:
            if added_cond is None:
                raise ValueError("this UNet's configuration takes added_cond "
                                 "(text_embeds and time_ids)")
            temb = temb + self.add_embedding(self.text_time_embedding(added_cond).to(dt))
        context = encoder_hidden_states.to(dt)
        x = conv2d_frames(self.conv_in, sample.to(dt))
        skips = [x]
        for blk in self.down_blocks:
            x, states = self._block(blk, x, temb, context, video_start_index)
            skips.extend(states)
        x = self._block(self.mid_block, x, temb, context, video_start_index)
        n_res = cfg.layers_per_block + 1
        split = uses_split_skip(cfg, x.shape[0], split_skip)
        for blk in self.up_blocks:
            block_skips = skips[-n_res:]
            del skips[-n_res:]
            x = self._block(blk, x, block_skips, temb, context, video_start_index, split)
        x = self.conv_norm_out(x, silu=True)
        return conv2d_frames(self.conv_out, x)
