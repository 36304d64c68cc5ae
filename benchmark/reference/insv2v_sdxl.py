"""Plain float32 reference of InsV2V at SDXL scale: the SDXL
InstructPix2Pix UNet (diffusers/sdxl-instructpix2pix-768,
``unet/config.json``) inflated with the AnimateDiff-SDXL motion modules
(guoyww/AnimateDiff, SDXL branch, ``mm_sdxl_v10_beta``), SDXL's two text
towers with the pooled projection, the ``text_time`` added embedding and
the dual-CFG step.

Written from the published architecture over dicts of weights under the
diffusers / open_clip state-dict keys, as functions of plain torch
operations (``ops.py``) and of the SD-1.5 reference's pieces
(``insv2v.py``: the resnet, the motion module, the VAE, the DDIM tables);
it imports nothing of the program. Video tensors are (B, F, H, W, C).

Departures from the published description:

* the tokenizer is the offline hash tokenizer the benchmark hands the
  program (no BPE vocabulary ships), and both towers read the same ids,
  padded with the end token (SDXL's second tokenizer pads with "!");
* the negative prompt "" is encoded through both towers, as the SD-1.5
  editor does, where SDXL's pipelines zero the uncond embeddings of an
  empty negative prompt (``force_zeros_for_empty_prompt``);
* the image conditioning is the VAE's posterior sample, unscaled, as
  InsV2V conditions (diffusers' SDXL InstructPix2Pix takes the mode);
* attention is computed in blocks of its batch so that a 16-frame 3-way
  call at 768 x 768 fits one card in float32: the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import insv2v as ref
from .ops import attention, conv, group_norm, layer_norm, linear, timestep_embedding, upsample2x

SCALE_FACTOR = 0.13025
LOGIT_BUDGET = 2 ** 28  # logits a block of attention holds (1 GiB in float32)


# --- attention in blocks ---------------------------------------------------------

def blocked_heads_attention(qt, kt, vt, heads: int, bias=None):
    """Multi-head attention on (B, S, heads*d) projections, a few batch
    rows at a time."""
    b, sq, c = qt.shape
    d = c // heads
    rows = max(1, LOGIT_BUDGET // (heads * sq * kt.shape[1]))
    out = []
    for i in range(0, b, rows):
        split = lambda t: t[i: i + rows].reshape(-1, t.shape[1], heads, d).transpose(1, 2)
        o = attention(split(qt), split(kt), split(vt), 1.0 / math.sqrt(d), bias)
        out.append(o.transpose(1, 2).reshape(-1, sq, c))
    return torch.cat(out)


# --- text ------------------------------------------------------------------------

def _tower_layer(W, lp, x, heads, mask, act, hf: bool):
    """One pre-LN layer of a CLIP text tower: HF keys (``hf``) or open_clip's."""
    if hf:
        h = layer_norm(W, lp + "layer_norm1", x)
        a = blocked_heads_attention(linear(W, lp + "self_attn.q_proj", h),
                                    linear(W, lp + "self_attn.k_proj", h),
                                    linear(W, lp + "self_attn.v_proj", h), heads, mask)
        x = x + linear(W, lp + "self_attn.out_proj", a)
        return x + linear(W, lp + "mlp.fc2", act(linear(W, lp + "mlp.fc1",
                                                        layer_norm(W, lp + "layer_norm2", x))))
    h = layer_norm(W, lp + "ln_1", x)
    w, bias = W[lp + "attn.in_proj_weight"], W[lp + "attn.in_proj_bias"]
    q, k, v = (linear({"p.weight": wi, "p.bias": bi}, "p", h)
               for wi, bi in zip(w.chunk(3), bias.chunk(3)))
    x = x + linear(W, lp + "attn.out_proj", blocked_heads_attention(q, k, v, heads, mask))
    return x + linear(W, lp + "mlp.c_proj", act(linear(W, lp + "mlp.c_fc",
                                                       layer_norm(W, lp + "ln_2", x))))


def clip_penultimate(W, ids, layers: int = 12, heads: int = 12) -> torch.Tensor:
    """CLIP ViT-L/14 (HF keys under ``text_model.``): the hidden state after
    ``layers - 1`` layers, without the final LayerNorm."""
    p = "text_model."
    s = ids.shape[1]
    x = W[p + "embeddings.token_embedding.weight"].float()[ids] + \
        W[p + "embeddings.position_embedding.weight"].float()[:s][None]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    quick = lambda h: h * torch.sigmoid(1.702 * h)
    for i in range(layers - 1):
        x = _tower_layer(W, f"{p}encoder.layers.{i}.", x, heads, mask, quick, True)
    return x


def openclip_bigg(W, ids, layers: int = 32, heads: int = 20):
    """OpenCLIP ViT-bigG/14 (open_clip keys): (the state after ``layers -
    1`` blocks without ``ln_final``, ``ln_final`` of the last block's state
    at the first end token times ``text_projection``)."""
    s = ids.shape[1]
    x = W["token_embedding.weight"].float()[ids] + W["positional_embedding"].float()[:s][None]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    gelu = lambda h: F.gelu(h)
    for i in range(layers):
        if i == layers - 1:
            penultimate = x
        x = _tower_layer(W, f"transformer.resblocks.{i}.", x, heads, mask, gelu, False)
    eot = ids.argmax(dim=-1)
    last = layer_norm(W, "ln_final", x[torch.arange(x.shape[0], device=x.device), eot])
    return penultimate, last @ W["text_projection"].float()


def text(W, ids, cfg: dict):
    """Both towers on the same ids: (context (B, S, 768 + 1280), pooled)."""
    c, o = cfg["clip"], cfg["openclip"]
    first = clip_penultimate(W["text_encoder"], ids, c["num_layers"], c["num_heads"])
    second, pooled = openclip_bigg(W["text_encoder_2"], ids, o["num_layers"], o["num_heads"])
    return torch.cat([first, second], dim=-1), pooled


# --- UNet3D ----------------------------------------------------------------------

def add_embed(W, cfg: dict, pooled, time_ids) -> torch.Tensor:
    """diffusers' ``text_time`` added embedding: [pooled | each size id
    sinusoidal at ``addition_time_embed_dim``] through a linear, SiLU and a
    linear."""
    t = timestep_embedding(time_ids.flatten(), cfg["addition_time_embed_dim"])
    x = torch.cat([pooled.float(), t.reshape(time_ids.shape[0], -1)], dim=-1)
    return linear(W, "add_embedding.linear_2", F.silu(linear(W, "add_embedding.linear_1", x)))


def _transformer(W, p, x, ctx, heads, depth, groups):
    """Per-frame spatial transformer with linear projections and ``depth``
    blocks of self-attn, text cross-attn and GEGLU FF."""
    b, f, h, w, c = x.shape
    xn = group_norm(W, p + ".norm", x.reshape(b * f, h, w, c), groups, 1e-6, (1, 2))
    s = linear(W, p + ".proj_in", xn).reshape(b * f, h * w, c)
    ctx = ctx.float().repeat_interleave(f, dim=0)
    for k in range(depth):
        bp = f"{p}.transformer_blocks.{k}."
        n = layer_norm(W, bp + "norm1", s)
        s = s + linear(W, bp + "attn1.to_out.0", blocked_heads_attention(
            linear(W, bp + "attn1.to_q", n), linear(W, bp + "attn1.to_k", n),
            linear(W, bp + "attn1.to_v", n), heads))
        n = layer_norm(W, bp + "norm2", s)
        s = s + linear(W, bp + "attn2.to_out.0", blocked_heads_attention(
            linear(W, bp + "attn2.to_q", n), linear(W, bp + "attn2.to_k", ctx),
            linear(W, bp + "attn2.to_v", ctx), heads))
        s = s + ref._geglu_ff(W, bp + "ff", layer_norm(W, bp + "norm3", s))
    return linear(W, p + ".proj_out", s).reshape(b, f, h, w, c) + x


def unet3d(W, cfg: dict, sample, t, ctx, start: int, pooled, time_ids) -> torch.Tensor:
    """eps (B, F, h, w, 4) of sample (B, F, h, w, 8) at timesteps ``t``
    (B,), text ``ctx`` (B, 77, 2048), window start ``start``, pooled text
    (B, 1280) and size ids (B, 6)."""
    ch = cfg["block_out_channels"]
    heads, depth = cfg["attention_head_dim"], cfg["transformer_layers_per_block"]
    eps, g = cfg["norm_eps"], cfg["norm_num_groups"]
    n = len(ch)
    mm = lambda level: cfg["use_motion_module"] and 2 ** level in cfg["motion_module_resolutions"]
    temb = timestep_embedding(t, ch[0])
    temb = linear(W, "time_embedding.linear_2", F.silu(linear(W, "time_embedding.linear_1", temb)))
    temb = temb + add_embed(W, cfg, pooled, time_ids)
    x = conv(W, "conv_in", sample.float())
    skips = [x]
    for i, kind in enumerate(cfg["down_block_types"]):
        p = f"down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = ref._resnet(W, f"{p}.resnets.{j}", x, temb, g, eps)
            if kind.startswith("CrossAttn"):
                x = _transformer(W, f"{p}.attentions.{j}", x, ctx, heads[i], depth[i], g)
            if mm(i):
                x = ref._motion(W, f"{p}.motion_modules.{j}", x, start, cfg)
            skips.append(x)
        if i < n - 1:
            x = conv(W, f"{p}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = ref._resnet(W, "mid_block.resnets.0", x, temb, g, eps)
    x = _transformer(W, "mid_block.attentions.0", x, ctx, heads[-1], depth[-1], g)
    x = ref._resnet(W, "mid_block.resnets.1", x, temb, g, eps)
    for i, kind in enumerate(cfg["up_block_types"]):
        p, level = f"up_blocks.{i}", n - 1 - i
        for j in range(cfg["layers_per_block"] + 1):
            x = ref._resnet(W, f"{p}.resnets.{j}", torch.cat([x, skips.pop()], dim=-1), temb, g,
                            eps)
            if kind.startswith("CrossAttn"):
                x = _transformer(W, f"{p}.attentions.{j}", x, ctx, heads[level], depth[level], g)
            if mm(level):
                x = ref._motion(W, f"{p}.motion_modules.{j}", x, start, cfg)
        if i < n - 1:
            x = conv(W, f"{p}.upsamplers.0.conv", upsample2x(x))
    x = F.silu(group_norm(W, "conv_norm_out", x, g, eps, range(1, x.ndim - 1)))
    return conv(W, "conv_out", x)


# --- the guided step -------------------------------------------------------------

def edit_step(W, cfg, tables, i: int, lat, cond, ctx_uncond, ctx_cond, pooled_uncond,
              pooled_cond, time_ids, start: int, latent_ref=None, num_ref: int = 0,
              correct_until: int = 0, text_cfg: float = 7.5, img_cfg: float = 1.2):
    """``insv2v.edit_step`` with the ``text_time`` inputs: one 3-way UNet
    batch (uncond | image | image + text) carrying the uncond pooled
    embedding in its first two rows, the guidance, the ref anchoring while
    ``i < correct_until`` and the DDIM update. Returns (eps of the three
    branches, the guided and anchored eps, the next latent)."""
    a_t, a_prev = float(tables["a"][i]), float(tables["a_prev"][i])
    sample = torch.cat([torch.cat([lat] * 3), torch.cat([torch.zeros_like(cond), cond, cond])],
                       dim=-1)
    ctx = torch.cat([ctx_uncond, ctx_uncond, ctx_cond])
    pooled = torch.cat([pooled_uncond, pooled_uncond, pooled_cond])
    t = torch.full((3,), int(tables["t"][i]), device=lat.device)
    e3 = unet3d(W, cfg, sample, t, ctx, start, pooled, time_ids.expand(3, -1))
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


def size_ids(height: int, width: int, device=None) -> torch.Tensor:
    """SDXL's size conditioning of frames shown whole at their own size:
    original size, crop origin (0, 0), target size."""
    return torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                        device=device)


def vae_sample_frames(W, frames, eps, levels: int = 4, blocks: int = 2,
                      chunk: int = 4) -> torch.Tensor:
    """``insv2v.vae_sample`` a few frames at a time (the posterior is
    per frame)."""
    return torch.cat([ref.vae_sample(W, frames[i: i + chunk], eps[i: i + chunk], levels, blocks)
                      for i in range(0, frames.shape[0], chunk)])


def decode_frames(W, latents, scale: float = SCALE_FACTOR, levels: int = 4,
                  blocks: int = 2) -> torch.Tensor:
    return ref.decode_frames(W, latents, scale, levels, blocks, chunk=2)


def sub_weights(W: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The weights under ``prefix``, with it stripped."""
    return {k[len(prefix):]: v for k, v in W.items() if k.startswith(prefix)}
