"""ModelScope (DAMO) text-to-video UNet, the data-generation model, as torch
modules over ``(B, F, H, W, C)``.

Counterpart of ``models/modelscope_t2v.py`` in the JAX package (itself
modules/damo_text_to_video/unet_sd.py: UNetSD, CrossAttention with the
prompt-to-prompt hooks, the spatial and temporal transformers, ResBlock
and TemporalConvBlock_v2). Modules are laid out as the reference's
``ModuleList``s, so ``state_dict()`` has its key layout
(``input_blocks.N.M``, ``middle_block.M``, ``output_blocks.N.M``,
``out.0/2``, ``time_embed.0/2``, the ``temopral_conv`` typo, Conv3d
(O, I, 3, 1, 1) temporal convs, Conv1d k = 1 temporal projections) and a
``text2video_pytorch_model.pth`` loads as it is.

The prompt-to-prompt surgery is two call arguments, as in the JAX
package: ``sa_share`` (the new branches of the 4-way [old, new] x
[uncond, cond] batch attend with the old branches' self-attention maps)
and a ``(key_context, value_context)`` tuple for the cross-attention.

GroupNorm statistics: the ResBlocks and the output head per frame, the
spatial transformer per frame (eps 1e-6), the temporal transformer (eps
1e-6) and the temporal convs across (F, H, W). Attention goes through
``dot_attention_bshd``: kernel A at d = 64 for the spatial self-attention
at S >= 256, the plain path for the 77-token cross-attention and the
16-frame temporal attention. The GEGLU feed-forward is plain PyTorch (no
LayerNorm is fused into it, so it is not kernel B's function).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from insv2v_torch.models.unet3d import FeedForward, GroupNorm, LayerNorm, conv2d_frames
from insv2v_torch.ops.attention import dot_attention_bshd
from insv2v_torch.ops.resize import nearest_upsample_2x

__all__ = ["ModelScopeConfig", "UNetSD", "sinusoidal_embedding"]

Context = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ModelScopeConfig:
    """ModelScope's configuration.json: 4 -> 4 channels, dim 320, text
    context 1024, heads of 64, 2 res blocks, attention at scales 1, 1/2, 1/4."""

    in_dim: int = 4
    dim: int = 320
    context_dim: int = 1024
    out_dim: int = 4
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    head_dim: int = 64
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = (1.0, 0.5, 0.25)
    temporal_attention: bool = True

    @property
    def embed_dim(self) -> int:
        return self.dim * 4

    @classmethod
    def tiny(cls, **kw) -> "ModelScopeConfig":
        """The JAX package's fixture-sized config, for CPU tests."""
        d = dict(in_dim=4, dim=16, context_dim=12, out_dim=4, dim_mult=(1, 2), head_dim=8,
                 num_res_blocks=1, attn_scales=(1.0, 0.5))
        d.update(kw)
        return cls(**d)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t (B,) -> (B, dim) float32 in the reference's [cos | sin] order."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(c: int, eps: float = 1e-5) -> GroupNorm:
    """GroupNorm over the largest group count <= 32 that divides c (the
    full-width channels are multiples of 32; the tiny configs need it)."""
    g = min(32, c)
    while c % g:
        g -= 1
    return GroupNorm(g, c, eps=eps)


class PtpCrossAttention(nn.Module):
    """Self- or cross-attention with the prompt-to-prompt behaviours as
    call arguments. x (B, S, C); ``context`` None (self-attention), a
    tensor, or a (key_context, value_context) tuple."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x, context: Optional[Context] = None, sa_share: bool = False):
        q = self.to_q(x)
        if context is None:
            k_src = v_src = x
        elif isinstance(context, (tuple, list)):
            k_src, v_src = context
        else:
            k_src = v_src = context
        k, v = self.to_k(k_src), self.to_v(v_src)
        if context is None and sa_share:
            # groups 1 and 3 of the 4-way batch take the logits of groups 0
            # and 2: Q and K gathered from those groups, each keeping its V
            def g4(t):
                pairs = t.reshape((2, 2, t.shape[0] // 4) + t.shape[1:])
                return pairs[:, :1].expand(pairs.shape).reshape(t.shape)

            q, k = g4(q), g4(k)
        return self.to_out[0](dot_attention_bshd(q, k, v, self.heads))


class GeGluFeedForward(FeedForward):
    """``ff.net.0.proj`` -> a * gelu(gate) (exact erf) -> ``ff.net.2``, in
    stock PyTorch."""

    def forward(self, x):
        a, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](a * F.gelu(gate))


class MsBasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention (self again when the context is
    None) and the GEGLU FF, each pre-LN and residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int]):
        super().__init__()
        self.attn1 = PtpCrossAttention(dim, heads, head_dim)
        self.ff = GeGluFeedForward(dim)
        self.attn2 = PtpCrossAttention(dim, heads, head_dim, context_dim)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context: Optional[Context], sa_share: bool = False):
        x = x + self.attn1(self.norm1(x), None, sa_share=sa_share)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class MsSpatialTransformer(nn.Module):
    """The per-frame spatial transformer (``use_linear``). x (B, F, H, W, C);
    the context is repeated for each frame."""

    def __init__(self, c: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.norm = _gn(c, 1e-6)
        self.proj_in = nn.Linear(c, inner)
        self.transformer_blocks = nn.ModuleList(
            [MsBasicTransformerBlock(inner, heads, head_dim, context_dim)])
        self.proj_out = nn.Linear(inner, c)

    def forward(self, x, context: Optional[Context], sa_share: bool = False):
        b, f, h, w, c = x.shape
        seq = self.norm(x.reshape(b * f, h, w, c)).reshape(b * f, h * w, c)
        rep = lambda t: t.repeat_interleave(f, dim=0)
        if isinstance(context, (tuple, list)):
            context = tuple(rep(t) for t in context)
        elif context is not None:
            context = rep(context)
        seq = self.transformer_blocks[0](self.proj_in(seq), context, sa_share=sa_share)
        return self.proj_out(seq).reshape(b, f, h, w, c) + x


class MsTemporalTransformer(nn.Module):
    """Self-attention over the frames of each pixel (``only_self_att``),
    with Conv1d k = 1 projections; its GroupNorm pools over (F, H, W)."""

    def __init__(self, c: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.norm = _gn(c, 1e-6)
        self.proj_in = nn.Conv1d(c, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [MsBasicTransformerBlock(inner, heads, head_dim, None)])
        self.proj_out = nn.Conv1d(inner, c, 1)

    def forward(self, x, sa_share: bool = False):
        b, f, h, w, c = x.shape
        seq = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
        seq = F.linear(seq, self.proj_in.weight[..., 0], self.proj_in.bias)
        seq = self.transformer_blocks[0](seq, None, sa_share=sa_share)
        seq = F.linear(seq, self.proj_out.weight[..., 0], self.proj_out.bias)
        return seq.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4) + x


def _tconv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A (3, 1, 1) Conv3d over (B, F, H, W, C): a conv over F alone."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias, padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


class TemporalConvBlock(nn.Module):
    """Four (GroupNorm, SiLU, Conv3d (3, 1, 1)) stages and a residual;
    conv4 starts at zero. The reference's conv2-4 hold a Dropout at index
    2, so their convs are ``convN.3``; a state dict with them at ``convN.2``
    (no Dropout, as the test oracle has it) loads too."""

    def __init__(self, c: int):
        super().__init__()
        conv = lambda: nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
        self.conv1 = nn.Sequential(_gn(c), nn.SiLU(), conv())
        self.conv2, self.conv3, self.conv4 = (
            nn.Sequential(_gn(c), nn.SiLU(), nn.Dropout(0.0), conv()) for _ in range(3))
        nn.init.zeros_(self.conv4[3].weight)
        nn.init.zeros_(self.conv4[3].bias)
        self._register_load_state_dict_pre_hook(self._conv_at_index_2)

    @staticmethod
    def _conv_at_index_2(state_dict, prefix, *_):
        for n in (2, 3, 4):
            for leaf in ("weight", "bias"):
                old = f"{prefix}conv{n}.2.{leaf}"
                if old in state_dict:
                    state_dict[f"{prefix}conv{n}.3.{leaf}"] = state_dict.pop(old)

    def forward(self, x):
        h = x
        for seq in (self.conv1, self.conv2, self.conv3, self.conv4):
            h = _tconv(seq[-1], seq[0](h, silu=True))
        return x + h


class MsResBlock(nn.Module):
    """GN-SiLU-conv, + the timestep projection, GN-SiLU-conv (zero init),
    + the skip, then the temporal conv stack. GroupNorm per frame."""

    def __init__(self, cin: int, embed_dim: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(_gn(cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(embed_dim, cout))
        self.out_layers = nn.Sequential(_gn(cout), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else None
        self.temopral_conv = TemporalConvBlock(cout)  # sic: the reference's name

    def forward(self, x, temb):
        per_frame = (2, 3)
        h = conv2d_frames(self.in_layers[2], self.in_layers[0](x, per_frame, silu=True))
        h = h + self.emb_layers[1](F.silu(temb))[:, None, None, None, :]
        h = conv2d_frames(self.out_layers[3], self.out_layers[0](h, per_frame, silu=True))
        if self.skip_connection is not None:
            x = conv2d_frames(self.skip_connection, x)
        return self.temopral_conv(x + h)


class MsDownsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return conv2d_frames(self.op, x)


class MsUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return conv2d_frames(self.conv, nearest_upsample_2x(x))


class UNetSD(nn.Module):
    """x (B, F, h, w, in_dim), t (B,) or a scalar, context (B, L,
    context_dim) or a (key, value) tuple of such; ``sa_share`` for
    prompt-to-prompt phase 1 (B a multiple of 4). Returns eps
    (B, F, h, w, out_dim)."""

    def __init__(self, cfg: ModelScopeConfig = ModelScopeConfig()):
        super().__init__()
        self.cfg = cfg
        embed, hd = cfg.embed_dim, cfg.head_dim
        self.time_embed = nn.Sequential(nn.Linear(cfg.dim, embed), nn.SiLU(),
                                        nn.Linear(embed, embed))

        def attn_blocks(c):
            out = [MsSpatialTransformer(c, c // hd, hd, cfg.context_dim)]
            if cfg.temporal_attention:
                out.append(MsTemporalTransformer(c, c // hd, hd))
            return out

        init = [nn.Conv2d(cfg.in_dim, cfg.dim, 3, padding=1)]
        if cfg.temporal_attention:
            init.append(MsTemporalTransformer(cfg.dim, cfg.dim // hd, hd))
        self.input_blocks = nn.ModuleList([nn.ModuleList(init)])
        enc = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        skips, scale, levels = [cfg.dim], 1.0, len(cfg.dim_mult)
        for i, (cin, cout) in enumerate(zip(enc[:-1], enc[1:])):
            for j in range(cfg.num_res_blocks):
                block = [MsResBlock(cin, embed, cout)]
                if scale in cfg.attn_scales:
                    block += attn_blocks(cout)
                cin = cout
                self.input_blocks.append(nn.ModuleList(block))
                skips.append(cout)
                if i != levels - 1 and j == cfg.num_res_blocks - 1:
                    self.input_blocks.append(MsDownsample(cout))
                    skips.append(cout)
                    scale /= 2.0

        ch = enc[-1]
        mid = [MsResBlock(ch, embed, ch), MsSpatialTransformer(ch, ch // hd, hd, cfg.context_dim)]
        if cfg.temporal_attention:
            mid.append(MsTemporalTransformer(ch, ch // hd, hd))
        self.middle_block = nn.ModuleList(mid + [MsResBlock(ch, embed, ch)])

        dec = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
        self.output_blocks = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(dec[:-1], dec[1:])):
            for j in range(cfg.num_res_blocks + 1):
                block = [MsResBlock(cin + skips.pop(), embed, cout)]
                if scale in cfg.attn_scales:
                    block += attn_blocks(cout)
                cin = cout
                if i != levels - 1 and j == cfg.num_res_blocks:
                    block.append(MsUpsample(cout))
                    scale *= 2.0
                self.output_blocks.append(nn.ModuleList(block))
        self.out = nn.Sequential(_gn(cout), nn.SiLU(), nn.Conv2d(cout, cfg.out_dim, 3, padding=1))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)

    @staticmethod
    def _run(block, h, temb, context, sa_share):
        for m in (block if isinstance(block, nn.ModuleList) else [block]):
            if isinstance(m, MsResBlock):
                h = m(h, temb)
            elif isinstance(m, MsSpatialTransformer):
                h = m(h, context, sa_share=sa_share)
            elif isinstance(m, MsTemporalTransformer):
                h = m(h, sa_share=sa_share)
            elif isinstance(m, nn.Conv2d):
                h = conv2d_frames(m, h)
            else:  # MsDownsample, MsUpsample
                h = m(h)
        return h

    def forward(self, x, t, context: Context, sa_share: bool = False):
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        dtype = self.time_embed[0].weight.dtype
        temb = self.time_embed[2](F.silu(self.time_embed[0](
            sinusoidal_embedding(t, self.cfg.dim).to(dtype))))
        if isinstance(context, (tuple, list)):
            context = tuple(c.to(dtype) for c in context)
        else:
            context = context.to(dtype)
        h, skips = x.to(dtype), []
        for block in self.input_blocks:
            h = self._run(block, h, temb, context, sa_share)
            skips.append(h)
        h = self._run(self.middle_block, h, temb, context, sa_share)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, skips.pop()], dim=-1), temb, context, sa_share)
        h = self.out[0](h, (2, 3), silu=True)
        return conv2d_frames(self.out[2], h)
