"""Plain float32 reference of InsV2V (configs/instruct_v2v.yaml of
amazon-science/instruct-video-to-video, arXiv 2311.00213): the CLIP
ViT-L/14 text tower, the SD KL autoencoder, the SD-1.5 InstructPix2Pix
UNet inflated with AnimateDiff motion modules, the DDIM tables and the
dual-CFG step with ref-frame anchoring.

Written from the published architecture over a dict of weights under the
reference's state-dict keys, as functions of plain torch operations
(``ops.py``); it imports nothing of the program. Video tensors are
(B, F, H, W, C), images (N, H, W, C). Departures from the published
model: none in the mathematics; the tokenizer is the offline hash
tokenizer the benchmark hands the program (no BPE vocabulary ships).
"""

from __future__ import annotations

import html
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .ops import (attention, conv, group_norm, heads_attention, layer_norm, linear,
                 timestep_embedding, upsample2x)

SCALE_FACTOR = 0.18215


# --- text ------------------------------------------------------------------

def hash_token_ids(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """The offline tokenizer: lower-cased whitespace words, each an FNV-1a
    hash modulo 49406, between start (49406) and end (49407) tokens,
    padded with the end token."""
    out = np.full((len(texts), max_len), 49407, dtype=np.int64)
    for i, text in enumerate(texts):
        ids = []
        for word in html.unescape(html.unescape(text)).strip().lower().split():
            h = 2166136261
            for c in word.encode("utf-8"):
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            ids.append(h % 49406)
        ids = [49406] + ids[: max_len - 2] + [49407]
        out[i, : len(ids)] = ids
    return out


def clip_text(W: Dict[str, torch.Tensor], ids: torch.Tensor, layers: int = 12,
              heads: int = 12) -> torch.Tensor:
    """CLIP text tower: last hidden state (B, 77, 768) after the final LN."""
    p = "text_model."
    s = ids.shape[1]
    x = W[p + "embeddings.token_embedding.weight"].float()[ids] + \
        W[p + "embeddings.position_embedding.weight"].float()[:s][None]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    for i in range(layers):
        lp = f"{p}encoder.layers.{i}."
        h = layer_norm(W, lp + "layer_norm1", x)
        a = heads_attention(linear(W, lp + "self_attn.q_proj", h),
                            linear(W, lp + "self_attn.k_proj", h),
                            linear(W, lp + "self_attn.v_proj", h), heads, mask)
        x = x + linear(W, lp + "self_attn.out_proj", a)
        h = linear(W, lp + "mlp.fc1", layer_norm(W, lp + "layer_norm2", x))
        x = x + linear(W, lp + "mlp.fc2", h * torch.sigmoid(1.702 * h))
    return layer_norm(W, p + "final_layer_norm", x)


# --- VAE -------------------------------------------------------------------

def _vae_norm(W, p, x):
    return group_norm(W, p, x, 32, 1e-6, range(1, x.ndim - 1))


def _vae_resnet(W, p, x):
    h = conv(W, p + ".conv1", F.silu(_vae_norm(W, p + ".norm1", x)))
    h = conv(W, p + ".conv2", F.silu(_vae_norm(W, p + ".norm2", h)))
    if p + ".nin_shortcut.weight" in W:
        x = linear(W, p + ".nin_shortcut", x)
    return x + h


def _vae_attn(W, p, x):
    n, hh, ww, c = x.shape
    h = _vae_norm(W, p + ".norm", x)
    seq = lambda name: linear(W, f"{p}.{name}", h).reshape(n, hh * ww, c)
    o = attention(seq("q"), seq("k"), seq("v"), 1.0 / math.sqrt(c)).reshape(n, hh, ww, c)
    return x + linear(W, p + ".proj_out", o)


def _vae_mid(W, p, h):
    h = _vae_resnet(W, p + ".block_1", h)
    return _vae_resnet(W, p + ".block_2", _vae_attn(W, p + ".attn_1", h))


def vae_moments(W, x, levels: int = 4, blocks: int = 2) -> torch.Tensor:
    """Encoder + quant_conv: images (N, H, W, 3) -> (N, h, w, 8)."""
    h = conv(W, "encoder.conv_in", x)
    for i in range(levels):
        for j in range(blocks):
            h = _vae_resnet(W, f"encoder.down.{i}.block.{j}", h)
        if i != levels - 1:
            h = conv(W, f"encoder.down.{i}.downsample.conv", h, stride=2, padding=(0, 1, 0, 1))
    h = _vae_mid(W, "encoder.mid", h)
    h = conv(W, "encoder.conv_out", F.silu(_vae_norm(W, "encoder.norm_out", h)))
    return linear(W, "quant_conv", h)


def vae_sample(W, x, eps, levels: int = 4, blocks: int = 2) -> torch.Tensor:
    """The posterior sample mean + std * eps (unscaled latent)."""
    mean, logvar = vae_moments(W, x, levels, blocks).chunk(2, dim=-1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps.float()


def vae_decode(W, z, levels: int = 4, blocks: int = 2) -> torch.Tensor:
    """post_quant_conv + decoder: latents (N, h, w, 4) -> images (N, H, W, 3)."""
    h = conv(W, "decoder.conv_in", linear(W, "post_quant_conv", z))
    h = _vae_mid(W, "decoder.mid", h)
    for i in reversed(range(levels)):
        for j in range(blocks + 1):
            h = _vae_resnet(W, f"decoder.up.{i}.block.{j}", h)
        if i != 0:
            h = conv(W, f"decoder.up.{i}.upsample.conv", upsample2x(h))
    return conv(W, "decoder.conv_out", F.silu(_vae_norm(W, "decoder.norm_out", h)))


def decode_frames(W, latents, scale: float = SCALE_FACTOR, levels: int = 4, blocks: int = 2,
                  chunk: int = 8) -> torch.Tensor:
    """Scaled latents (F, h, w, 4) -> frames in [-1, 1], chunk by chunk."""
    z = latents.float() / scale
    return torch.cat([vae_decode(W, z[i: i + chunk], levels, blocks).clamp(-1.0, 1.0)
                      for i in range(0, z.shape[0], chunk)])


# --- UNet3D ----------------------------------------------------------------

def temporal_pe(dim: int, start: int, frames: int, max_len: int, device) -> torch.Tensor:
    """AnimateDiff's sinusoidal table rows for a window from ``start``
    (a window that would overrun the table restarts at start - max_len)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    if start + frames > max_len:
        start -= max_len
    start = max(start, 0)
    return torch.as_tensor(pe[start: start + frames], dtype=torch.float32, device=device)


def _resnet(W, p, x, temb, groups, eps):
    """GroupNorm over frames and pixels, SiLU, conv; + time; again; shortcut."""
    axes = range(1, x.ndim - 1)
    h = conv(W, p + ".conv1", F.silu(group_norm(W, p + ".norm1", x, groups, eps, axes)))
    h = h + linear(W, p + ".time_emb_proj", F.silu(temb))[:, None, None, None, :]
    h = conv(W, p + ".conv2", F.silu(group_norm(W, p + ".norm2", h, groups, eps, axes)))
    if p + ".conv_shortcut.weight" in W:
        x = linear(W, p + ".conv_shortcut", x)
    return x + h


def _geglu_ff(W, p, x):
    h, gate = linear(W, p + ".net.0.proj", x).chunk(2, dim=-1)
    return linear(W, p + ".net.2", h * F.gelu(gate))


def _transformer(W, p, x, ctx, heads, groups):
    """Per-frame spatial transformer: self-attn, text cross-attn, GEGLU FF."""
    b, f, h, w, c = x.shape
    xn = group_norm(W, p + ".norm", x.reshape(b * f, h, w, c), groups, 1e-6, (1, 2))
    s = linear(W, p + ".proj_in", xn).reshape(b * f, h * w, c)
    ctx = ctx.float().repeat_interleave(f, dim=0)
    bp = p + ".transformer_blocks.0."
    n = layer_norm(W, bp + "norm1", s)
    s = s + linear(W, bp + "attn1.to_out.0", heads_attention(
        linear(W, bp + "attn1.to_q", n), linear(W, bp + "attn1.to_k", n),
        linear(W, bp + "attn1.to_v", n), heads))
    n = layer_norm(W, bp + "norm2", s)
    s = s + linear(W, bp + "attn2.to_out.0", heads_attention(
        linear(W, bp + "attn2.to_q", n), linear(W, bp + "attn2.to_k", ctx),
        linear(W, bp + "attn2.to_v", ctx), heads))
    s = s + _geglu_ff(W, bp + "ff", layer_norm(W, bp + "norm3", s))
    return linear(W, p + ".proj_out", s).reshape(b, f, h, w, c) + x


def _motion(W, p, x, start, cfg):
    """AnimateDiff motion module: per pixel and head, attention over frames."""
    b, f, h, w, c = x.shape
    heads = cfg["motion_num_attention_heads"]
    tp = p + ".temporal_transformer"
    xn = group_norm(W, tp + ".norm", x.reshape(b * f, h, w, c), cfg["norm_num_groups"], 1e-6,
                    (1, 2))
    s = linear(W, tp + ".proj_in", xn.reshape(b, f, h * w, c)).transpose(1, 2)  # (B, P, F, C)
    bp = tp + ".transformer_blocks.0."
    pe = temporal_pe(c, start, f, cfg["motion_max_seq_length"], x.device)
    for k in range(len(cfg["motion_attention_block_types"])):
        ap = f"{bp}attention_blocks.{k}"
        n = layer_norm(W, f"{bp}norms.{k}", s) + pe
        split = lambda t: t.reshape(b, h * w, f, heads, c // heads).transpose(2, 3)
        o = attention(split(linear(W, ap + ".to_q", n)), split(linear(W, ap + ".to_k", n)),
                      split(linear(W, ap + ".to_v", n)), (c // heads) ** -0.5)
        s = s + linear(W, ap + ".to_out.0", o.transpose(2, 3).reshape(b, h * w, f, c))
    s = s + _geglu_ff(W, bp + "ff", layer_norm(W, bp + "ff_norm", s))
    s = linear(W, tp + ".proj_out", s).transpose(1, 2)
    return s.reshape(b, f, h, w, c) + x


def unet3d(W, cfg: dict, sample, t, ctx, start: int) -> torch.Tensor:
    """eps (B, F, h, w, 4) of sample (B, F, h, w, 8) at timesteps ``t``
    (B,), text ``ctx`` (B, 77, 768), window start ``start``."""
    ch = cfg["block_out_channels"]
    heads, eps, g = cfg["attention_head_dim"], cfg["norm_eps"], cfg["norm_num_groups"]
    n = len(ch)
    mm = lambda level: cfg["use_motion_module"] and 2 ** level in cfg["motion_module_resolutions"]
    temb = timestep_embedding(t, ch[0])
    temb = linear(W, "time_embedding.linear_2", F.silu(linear(W, "time_embedding.linear_1", temb)))
    x = conv(W, "conv_in", sample.float())
    skips = [x]
    for i, kind in enumerate(cfg["down_block_types"]):
        p = f"down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = _resnet(W, f"{p}.resnets.{j}", x, temb, g, eps)
            if kind == "CrossAttnDownBlock3D":
                x = _transformer(W, f"{p}.attentions.{j}", x, ctx, heads, g)
            if mm(i):
                x = _motion(W, f"{p}.motion_modules.{j}", x, start, cfg)
            skips.append(x)
        if i < n - 1:
            x = conv(W, f"{p}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = _resnet(W, "mid_block.resnets.0", x, temb, g, eps)
    x = _transformer(W, "mid_block.attentions.0", x, ctx, heads, g)
    x = _resnet(W, "mid_block.resnets.1", x, temb, g, eps)
    for i, kind in enumerate(cfg["up_block_types"]):
        p = f"up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            x = _resnet(W, f"{p}.resnets.{j}", torch.cat([x, skips.pop()], dim=-1), temb, g, eps)
            if kind == "CrossAttnUpBlock3D":
                x = _transformer(W, f"{p}.attentions.{j}", x, ctx, heads, g)
            if mm(n - 1 - i):
                x = _motion(W, f"{p}.motion_modules.{j}", x, start, cfg)
        if i < n - 1:
            x = conv(W, f"{p}.upsamplers.0.conv", upsample2x(x))
    x = F.silu(group_norm(W, "conv_norm_out", x, g, eps, range(1, x.ndim - 1)))
    return conv(W, "conv_out", x)


# --- sampler ---------------------------------------------------------------

def ddim_tables(steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012) -> Dict[str, np.ndarray]:
    """diffusers DDIM: scaled-linear betas, 'leading' spacing, offset 1,
    final alpha-bar = alpha-bar[0], eta 0."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps) ** 2
    ac = np.cumprod(1.0 - betas)
    ratio = train_steps // steps
    ts = (np.arange(steps) * ratio)[::-1] + 1
    prev = ts - ratio
    return {"t": ts, "a": ac[ts], "a_prev": np.where(prev >= 0, ac[np.maximum(prev, 0)], ac[0])}


def window_windows(frames: int, per_window: int, refs: int) -> List[tuple]:
    """(start, frames, refs) of each sliding window: full first window,
    then windows re-using the previous one's last frames as refs; a short
    remainder takes more refs so every window has ``per_window`` frames."""
    if frames <= per_window:
        return [(0, frames, 0)]
    out, ptr = [(0, per_window, 0)], per_window
    while ptr < frames:
        new = frames - ptr if frames - ptr < per_window else per_window - refs
        out.append((ptr - (per_window - new), per_window, per_window - new))
        ptr += new
    return out


def edit_step(W, cfg, tables, i: int, lat, cond, ctx_uncond, ctx_cond, start: int,
              latent_ref=None, num_ref: int = 0, correct_until: int = 0,
              text_cfg: float = 7.5, img_cfg: float = 1.2):
    """One step of the dual-CFG window sampler from ``lat`` (1, F, h, w, 4):
    one 3-way UNet batch (uncond | image | image + text), the guidance
    combination, the ref frames' implied-noise anchoring while
    ``i < correct_until``, and the DDIM update. Returns (eps of the three
    branches, the guided and anchored eps, the next latent)."""
    a_t, a_prev = float(tables["a"][i]), float(tables["a_prev"][i])
    sample = torch.cat([torch.cat([lat] * 3), torch.cat([torch.zeros_like(cond), cond, cond])],
                       dim=-1)
    ctx = torch.cat([ctx_uncond, ctx_uncond, ctx_cond])
    t = torch.full((3,), int(tables["t"][i]), device=lat.device)
    e3 = unet3d(W, cfg, sample, t, ctx, start)
    e_u, e_i, e_t = e3.chunk(3)
    eps = e_u + img_cfg * (e_i - e_u) + text_cfg * (e_t - e_i)
    if latent_ref is not None and i < correct_until:
        mask = (torch.arange(lat.shape[1], device=lat.device) < num_ref).float()
        mask = mask[None, :, None, None, None]
        noise_ref = (lat - math.sqrt(a_t) * latent_ref) / math.sqrt(1.0 - a_t)
        delta = (noise_ref - eps) * mask
        eps = eps + mask * delta + (1.0 - mask) * delta.sum(dim=1, keepdim=True) / max(num_ref, 1)
    x0 = (lat - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
    return e3, eps, math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


def ddim_eps(tables, i: int, x, x_next):
    """The noise estimate an eta-0 DDIM step from ``x`` to ``x_next`` used:
    x_next = sqrt(a_prev / a_t) x + (sqrt(1 - a_prev) - sqrt(a_prev (1 - a_t) / a_t)) eps."""
    a_t, a_prev = float(tables["a"][i]), float(tables["a_prev"][i])
    c = math.sqrt(1.0 - a_prev) - math.sqrt(a_prev * (1.0 - a_t) / a_t)
    return (x_next.double() - math.sqrt(a_prev / a_t) * x.double()) / c
