"""Plain float32 reference of ModelScope text-to-video data generation
(damo-vilab text-to-video-synthesis, configuration.json; arXiv
2308.06571), as the InsV2V reference's ``modules/damo_text_to_video``
carries it: the OpenCLIP ViT-H/14 text tower to its penultimate block,
the UNetSD with its spatial and temporal transformers and temporal convs,
the prompt-to-prompt surgery (the 4-way batch's self-attention sharing
and the token-aligned (key, value) cross-attention context), its
three-phase DDIM pair sampler, and the CLIP ViT-L/14 directional scores
that filter pairs.

Functions of plain torch operations (``ops.py``) over dicts of weights
under the published state-dict keys; imports nothing of the program.
Video tensors are (B, F, H, W, C).
"""

from __future__ import annotations

import difflib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import conv, group_norm, heads_attention, layer_norm, linear, q


def groups_for(c: int) -> int:
    """The largest group count <= 32 that divides c."""
    g = min(32, c)
    while c % g:
        g -= 1
    return g


# --- OpenCLIP text ----------------------------------------------------------

def openclip_text(W, ids, layers: int = 24, heads: int = 16) -> torch.Tensor:
    """Hidden states (B, 77, width) after block ``layers - 1`` and ln_final."""
    s = ids.shape[1]
    x = W["token_embedding.weight"].float()[ids] + W["positional_embedding"].float()[:s][None]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    for i in range(layers - 1):
        p = f"transformer.resblocks.{i}."
        h = layer_norm(W, p + "ln_1", x)
        qkv = F.linear(q(h), q(W[p + "attn.in_proj_weight"]), W[p + "attn.in_proj_bias"].float())
        a = heads_attention(*qkv.chunk(3, dim=-1), heads, mask)
        x = x + linear(W, p + "attn.out_proj", a)
        x = x + linear(W, p + "mlp.c_proj", F.gelu(linear(W, p + "mlp.c_fc",
                                                            layer_norm(W, p + "ln_2", x))))
    return layer_norm(W, "ln_final", x)


# --- prompt-to-prompt contexts (misc_utils/video_ptp_utils.py, ptp_utils.py) --

def word_pieces(old: str, new: str) -> List[Tuple[str, str]]:
    """The word diff of two captions as (old, new) pieces: kept text,
    deletions (new ""), insertions (old "") and, for a deletion next to
    an insertion, one edit."""
    diff = list(difflib.Differ().compare(old.split(), new.split()))
    runs, i = [], 0
    while i < len(diff):
        tag = diff[i][0]
        if tag in (" ", "-", "+"):
            words = [diff[i][2:]]
            while i + 1 < len(diff) and diff[i + 1][0] == tag:
                i += 1
                words.append(diff[i][2:])
            runs.append((tag, " ".join(words)))
        i += 1
    pieces, i = [], 0
    while i < len(runs):
        tag, text = runs[i]
        if i + 1 < len(runs) and {tag, runs[i + 1][0]} == {"-", "+"}:
            d = text if tag == "-" else runs[i + 1][1]
            a = runs[i + 1][1] if tag == "-" else text
            pieces.append(("edit", d, a))
            i += 2
            continue
        pieces.append({" ": ("text", text, text), "-": ("delete", text, ""),
                       "+": ("insert", "", text)}[tag])
        i += 1
    return pieces


def ptp_key_value(pieces, edit_weight: float, count_tokens, ids_of, encode):
    """(key, value) contexts (1, L, D): the new caption's embeddings, where
    each new token that maps to an old one takes the old caption's
    embedding as its key, and every value is scaled by its piece's weight
    (``edit_weight`` where the piece changes the text)."""
    old_prompt = " ".join(p[1] for p in pieces)
    new_prompt = " ".join(p[2] for p in pieces)
    old_emb, new_emb = encode(ids_of(old_prompt)), encode(ids_of(new_prompt))
    n_old, new_to_old, weights = 0, [], []
    for kind, old, new in pieces:
        n_o = count_tokens(old) if old else 0
        n_n = count_tokens(new) if new else 0
        if n_o == 0 and n_n == 0:
            continue
        if old == new:
            n_old += n_o
            new_to_old += list(range(n_old - n_o, n_old))
        elif n_o == 0:
            new_to_old += [-1] * n_n
        elif n_n == 0:
            n_old += n_o
        else:
            n_old += n_o
            new_to_old += np.linspace(n_old - n_o, n_old, n_n, endpoint=False).astype(int).tolist()
        weights += [1.0 if old == new else edit_weight] * n_n
    key, value = new_emb.clone(), new_emb.clone()
    length = key.shape[1]
    for i, (j, w) in enumerate(zip(new_to_old, weights)):
        if i + 1 >= length:
            break
        if 0 <= j and j + 1 < length:
            key[0, i + 1] = old_emb[0, j + 1]
        value[0, i + 1] = value[0, i + 1] * w
    return key, value


# --- UNetSD -----------------------------------------------------------------

def _gn(W, p, x, axes, eps=1e-5):
    return group_norm(W, p, x, groups_for(x.shape[-1]), eps, axes)


def _attn(W, p, x, heads, context=None, share=False):
    """Self-attention (``context`` None), cross-attention, or the (key,
    value) pair; ``share``: batch groups 1 and 3 of 4 take the queries and
    keys of groups 0 and 2 (their own values)."""
    k_src, v_src = (x, x) if context is None else (
        context if isinstance(context, tuple) else (context, context))
    qt, kt, vt = linear(W, p + ".to_q", x), linear(W, p + ".to_k", k_src), linear(W, p + ".to_v", v_src)
    if context is None and share:
        g4 = lambda t: t.reshape((2, 2, t.shape[0] // 4) + t.shape[1:])[:, :1].expand(
            (2, 2, t.shape[0] // 4) + t.shape[1:]).reshape(t.shape)
        qt, kt = g4(qt), g4(kt)
    return linear(W, p + ".to_out.0", heads_attention(qt, kt, vt, heads))


def _block(W, p, x, context, heads, share):
    x = x + _attn(W, p + ".attn1", layer_norm(W, p + ".norm1", x), heads, None, share)
    x = x + _attn(W, p + ".attn2", layer_norm(W, p + ".norm2", x), heads, context)
    h, gate = linear(W, p + ".ff.net.0.proj", layer_norm(W, p + ".norm3", x)).chunk(2, dim=-1)
    return x + linear(W, p + ".ff.net.2", h * F.gelu(gate))


def _spatial(W, p, x, context, head_dim, share):
    b, f, h, w, c = x.shape
    s = _gn(W, p + ".norm", x, (2, 3), 1e-6).reshape(b * f, h * w, c)
    rep = lambda t: t.float().repeat_interleave(f, dim=0)
    ctx = tuple(rep(t) for t in context) if isinstance(context, tuple) else rep(context)
    s = _block(W, p + ".transformer_blocks.0", linear(W, p + ".proj_in", s), ctx,
               c // head_dim, share)
    return linear(W, p + ".proj_out", s).reshape(b, f, h, w, c) + x


def _temporal(W, p, x, head_dim, share):
    b, f, h, w, c = x.shape
    s = _gn(W, p + ".norm", x, (1, 2, 3), 1e-6).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
    s = _block(W, p + ".transformer_blocks.0", linear(W, p + ".proj_in", s), None,
               c // head_dim, share)
    s = linear(W, p + ".proj_out", s)
    return s.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4) + x


def _tconv(W, p, x):
    """A (3, 1, 1) Conv3d over frames: GroupNorm over (F, H, W) first."""
    y = F.conv3d(q(x.permute(0, 4, 1, 2, 3)), q(W[p + ".weight"]), W[p + ".bias"].float(),
                 padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


def _resblock(W, p, x, temb):
    h = conv(W, p + ".in_layers.2", F.silu(_gn(W, p + ".in_layers.0", x, (2, 3))))
    h = h + linear(W, p + ".emb_layers.1", F.silu(temb))[:, None, None, None, :]
    h = conv(W, p + ".out_layers.3", F.silu(_gn(W, p + ".out_layers.0", h, (2, 3))))
    if p + ".skip_connection.weight" in W:
        x = conv(W, p + ".skip_connection", x, padding=0)
    x = x + h
    g = x
    for n, idx in ((1, 2), (2, 3), (3, 3), (4, 3)):
        cp = f"{p}.temopral_conv.conv{n}"
        g = _tconv(W, f"{cp}.{idx}", F.silu(_gn(W, f"{cp}.0", g, (1, 2, 3))))
    return x + g


def unetsd(W, cfg: dict, x, t, context, share: bool = False) -> torch.Tensor:
    """eps (B, F, h, w, 4) of x at timesteps ``t`` (B,); ``context`` a
    (B, 77, D) tensor or a (key, value) pair; ``share`` the 4-way batch's
    self-attention sharing."""
    dim, hd, nres = cfg["dim"], cfg["head_dim"], cfg["num_res_blocks"]
    mult, scales = cfg["dim_mult"], cfg["attn_scales"]
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    args = t.float()[:, None] * freqs[None]
    temb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    temb = linear(W, "time_embed.2", F.silu(linear(W, "time_embed.0", temb)))

    def attend(p, h, k0):
        h = _spatial(W, f"{p}.{k0}", h, context, hd, share)
        return _temporal(W, f"{p}.{k0 + 1}", h, hd, share)

    h = conv(W, "input_blocks.0.0", x.float())
    h = _temporal(W, "input_blocks.0.1", h, hd, share)
    skips, n, scale = [h], 1, 1.0
    enc = [dim * u for u in [1] + list(mult)]
    for i in range(len(mult)):
        for j in range(nres):
            p = f"input_blocks.{n}"
            h = _resblock(W, p + ".0", h, temb)
            if scale in scales:
                h = attend(p, h, 1)
            skips.append(h)
            n += 1
            if i != len(mult) - 1 and j == nres - 1:
                h = conv(W, f"input_blocks.{n}.op", h, stride=2)
                skips.append(h)
                n += 1
                scale /= 2.0
    h = _resblock(W, "middle_block.0", h, temb)
    h = attend("middle_block", h, 1)
    h = _resblock(W, "middle_block.3", h, temb)
    n = 0
    for i in range(len(mult)):
        for j in range(nres + 1):
            p = f"output_blocks.{n}"
            h = _resblock(W, p + ".0", torch.cat([h, skips.pop()], dim=-1), temb)
            k = 1
            if scale in scales:
                h = attend(p, h, 1)
                k = 3
            if i != len(mult) - 1 and j == nres:
                h = conv(W, f"{p}.{k}.conv", h.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2))
                scale *= 2.0
            n += 1
    h = F.silu(_gn(W, "out.0", h, (2, 3)))
    return conv(W, "out.2", h)


def ddim_update(tables, i: int, x, eps):
    a_t, a_prev = float(tables["a"][i]), float(tables["a_prev"][i])
    x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
    return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


def ptp_step(W, cfg, tables, i: int, phase: int, old, new, ctx, guidance: float):
    """One step of the pair sampler from (old, new), each (1, F, h, w, 4):
    phase 1 one 4-way call [old, new, old, new] under [uncond, uncond, old,
    new] with sharing; phases 2 and 3 two 2-way calls, the new branch under
    the (key, value) pair in phase 2 and the new caption in phase 3.
    ``ctx``: {'un', 'old', 'new', 'key', 'value'}, each (1, 77, D). Returns
    ({call: eps}, (guided eps of old, of new), next old, next new)."""
    t = lambda b: torch.full((b,), int(tables["t"][i]), device=old.device)
    cfg_eps = lambda e_u, e_c: e_u + guidance * (e_c - e_u)
    if phase == 1:
        e = unetsd(W, cfg, torch.cat([old, new, old, new]), t(4),
                   torch.cat([ctx["un"], ctx["un"], ctx["old"], ctx["new"]]), share=True)
        eu_o, eu_n, ec_o, ec_n = e.chunk(4)
        raw, g_old, g_new = {"joint": e}, cfg_eps(eu_o, ec_o), cfg_eps(eu_n, ec_n)
    else:
        e_old = unetsd(W, cfg, torch.cat([old, old]), t(2), torch.cat([ctx["un"], ctx["old"]]))
        if phase == 2:
            c_new = (torch.cat([ctx["un"], ctx["key"]]), torch.cat([ctx["un"], ctx["value"]]))
        else:
            c_new = torch.cat([ctx["un"], ctx["new"]])
        e_new = unetsd(W, cfg, torch.cat([new, new]), t(2), c_new)
        raw, g_old, g_new = ({"old": e_old, "new": e_new}, cfg_eps(*e_old.chunk(2)),
                             cfg_eps(*e_new.chunk(2)))
    return (raw, (g_old, g_new), ddim_update(tables, i, old, g_old),
            ddim_update(tables, i, new, g_new))


# --- CLIP ViT-L/14 scores ---------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _clip_layers(W, p, x, layers, heads, mask=None):
    for i in range(layers):
        lp = f"{p}.encoder.layers.{i}."
        h = layer_norm(W, lp + "layer_norm1", x)
        a = heads_attention(linear(W, lp + "self_attn.q_proj", h),
                            linear(W, lp + "self_attn.k_proj", h),
                            linear(W, lp + "self_attn.v_proj", h), heads, mask)
        x = x + linear(W, lp + "self_attn.out_proj", a)
        h = linear(W, lp + "mlp.fc1", layer_norm(W, lp + "layer_norm2", x))
        x = x + linear(W, lp + "mlp.fc2", h * torch.sigmoid(1.702 * h))
    return x


def resize_bilinear(x, h: int, w: int):
    """Bilinear resize of (N, H, W, C), half-pixel centres, no antialias
    (``F.interpolate``'s bilinear, align_corners False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def clip_image_features(W, frames, cfg: dict) -> torch.Tensor:
    """frames (N, H, W, 3) in [-1, 1] -> (N, projection) features."""
    size, patch = cfg["image_size"], cfg["patch_size"]
    x = resize_bilinear((frames.float() + 1.0) / 2.0, size, size)
    x = (x - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(CLIP_STD, device=x.device)
    p = "vision_model"
    pt = F.conv2d(q(x.permute(0, 3, 1, 2)), q(W[p + ".embeddings.patch_embedding.weight"]),
                  stride=patch).flatten(2).transpose(1, 2)
    cls = W[p + ".embeddings.class_embedding"].float().reshape(1, 1, -1).expand(pt.shape[0], 1, -1)
    h = torch.cat([cls, pt], dim=1)
    h = h + W[p + ".embeddings.position_embedding.weight"].float()[: h.shape[1]][None]
    h = layer_norm(W, p + ".pre_layrnorm", h)
    h = _clip_layers(W, p, h, cfg["num_layers"], cfg["num_heads"])
    return linear(W, "visual_projection", layer_norm(W, p + ".post_layernorm", h[:, 0]),
                  bias=False)


def clip_text_features(W, ids, layers: int = 12, heads: int = 12) -> torch.Tensor:
    p = "text_model"
    s = ids.shape[1]
    x = W[p + ".embeddings.token_embedding.weight"].float()[ids] + \
        W[p + ".embeddings.position_embedding.weight"].float()[:s][None]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    x = layer_norm(W, p + ".final_layer_norm", _clip_layers(W, p, x, layers, heads, mask))
    pooled = x[torch.arange(ids.shape[0], device=x.device), ids.argmax(dim=-1)]
    return linear(W, "text_projection", pooled, bias=False)


def clip_scores(W, cfg: dict, frames_0, frames_1, ids_0, ids_1) -> Dict[str, float]:
    """sim_0, sim_1, sim_dir, sim_image, each the mean over the frames."""
    cos = lambda a, b: ((a / (a.norm(dim=-1, keepdim=True) + 1e-8))
                        * (b / (b.norm(dim=-1, keepdim=True) + 1e-8))).sum(-1)
    i0, i1 = clip_image_features(W, frames_0, cfg), clip_image_features(W, frames_1, cfg)
    tl, th = cfg["text"]["num_layers"], cfg["text"]["num_heads"]
    t0, t1 = clip_text_features(W, ids_0, tl, th), clip_text_features(W, ids_1, tl, th)
    return {"sim_0": float(cos(i0, t0).mean()), "sim_1": float(cos(i1, t1).mean()),
            "sim_dir": float(cos(i1 - i0, t1 - t0).mean()), "sim_image": float(cos(i0, i1).mean())}
