"""Flax param tree -> torch state dict: the inverse of the JAX package's
``utils/convert.py`` converters, so one weight set can drive both
packages (and the JAX package's own trees can be served by the port).

``torch_state_dict_from_flax(tree, kind)`` for ``kind`` in
{"unet3d", "vae", "clip_text", "raft", "clip_model", "unet_sd",
"openclip_text", "t5", "class_embedder"} undoes
``convert_unet3d_state_dict``, ``convert_vae_state_dict``,
``convert_clip_text_state_dict``, ``convert_raft_state_dict``,
``convert_clip_model_state_dict``, ``convert_unet_sd_state_dict``,
``convert_openclip_text_state_dict`` and ``convert_t5_state_dict`` (a
``ClassEmbedder``'s tree is its one ``embedding`` table):

  * conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw)
  * dense ``kernel`` (I, O)        -> ``weight`` (O, I)
  * norm ``scale``                 -> ``weight``; ``embedding`` -> ``weight``
  * the module renamings in reverse (``down_blocks_0`` -> ``down_blocks.0``,
    ``ff/geglu_proj`` -> ``ff.net.0.proj``, ``to_out`` -> ``to_out.0``, ...);
  * RAFT: ``layer1_0`` -> ``layer1.0``, the 1x1 ``downsample`` conv ->
    ``downsample.0``, a BatchNorm's ``mean`` / ``var`` -> ``running_mean``
    / ``running_var``, and each ``norm3`` also as ``downsample.1`` (the
    princeton-vl modules register that norm under both names);
  * the HF ``CLIPModel``: ``text`` -> ``text_model.*``, ``vision`` ->
    ``vision_model.*`` (``embeddings.{class,patch,position}_embedding``,
    ``encoder.layers.N``), and the two bias-free projections;
  * ModelScope's UNetSD (``cfg``, its ``ModelScopeConfig``, is needed): the
    named modules back to the reference's ``input_blocks.N.M`` /
    ``middle_block.M`` / ``output_blocks.N.M`` numbering, walked in the
    reference's construction order; the temporal convs' kernels (3, I, O)
    -> Conv3d (O, I, 3, 1, 1), the temporal transformers' projections ->
    Conv1d (O, I, 1); ``temporal_conv`` -> ``temopral_conv`` (sic);
  * open_clip's text tower: q/k/v packed back into ``attn.in_proj_weight``
    / ``in_proj_bias``, ``resblocks_N`` -> ``transformer.resblocks.N``,
    ``c_fc`` / ``c_proj`` under ``mlp``;
  * T5: HF ``T5EncoderModel``'s keys (``block_N/attn/q`` ->
    ``encoder.block.N.layer.0.SelfAttention.q``, ``ln_attn`` / ``ln_ff``
    -> ``layer.{0,1}.layer_norm``, ``wi_0`` / ``wi_1`` / ``wo`` under
    ``layer.1.DenseReluDense``, the shared bias table under block 0's
    attention), with the tied ``encoder.embed_tokens.weight`` beside
    ``shared.weight``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flatten", "torch_state_dict_from_flax"]


def flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _leaf(name: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if v.ndim == 4:
            return "weight", np.transpose(v, (3, 2, 0, 1))
        if v.ndim == 2:
            return "weight", np.transpose(v)
        return "weight", v
    if name in ("scale", "embedding"):
        return "weight", v
    return name, v


_INDEXED = re.compile(r"^(down_blocks|up_blocks|resnets|attentions|motion_modules|"
                      r"transformer_blocks|attention_blocks|norms|layers)_(\d+)$")


def _unet_module(parts: List[str]) -> List[str]:
    out: List[str] = []
    for i, p in enumerate(parts):
        m = _INDEXED.match(p)
        if m:
            out += [m.group(1), m.group(2)]
            if m.group(1) == "motion_modules":
                out.append("temporal_transformer")
        elif p == "downsampler":
            out += ["downsamplers", "0"]
        elif p == "upsampler":
            out += ["upsamplers", "0"]
        elif p == "geglu_proj" and parts[i - 1] == "ff":
            out += ["net", "0", "proj"]
        elif p == "proj_out" and i > 0 and parts[i - 1] == "ff":
            out += ["net", "2"]
        elif p == "to_out":
            out += ["to_out", "0"]
        else:
            out.append(p)
    return out


_VAE_LEVEL = re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$")
_VAE_SAMPLE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")


def _vae_module(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        m, s = _VAE_LEVEL.match(p), _VAE_SAMPLE.match(p)
        if m:
            out += [m.group(1), m.group(2), m.group(3), m.group(4)]
        elif s:
            out += [s.group(1), s.group(2), s.group(3)]
        elif p in ("mid_block_1", "mid_attn_1", "mid_block_2"):
            out += ["mid", p[len("mid_"):]]
        else:
            out.append(p)
    return out


_RAFT_LAYER = re.compile(r"^layer(\d)_(\d)$")


def _raft_module(parts: List[str]) -> List[str]:
    out: List[str] = []
    for i, p in enumerate(parts):
        m = _RAFT_LAYER.match(p)
        if m:
            out += [f"layer{m.group(1)}", m.group(2)]
        elif p == "downsample":
            out += ["downsample", "0"]
        elif p in ("mask_0", "mask_2"):
            out += ["mask", p[-1]]
        elif p in ("mean", "var") and i == len(parts) - 1:
            out.append("running_" + p)
        else:
            out.append(p)
    return out


def _vision_module(parts: List[str]) -> List[str]:
    out = ["vision_model"]
    for p in parts:
        m = _INDEXED.match(p)
        if m and m.group(1) == "layers":
            out += ["encoder", "layers", m.group(2)]
        elif p in ("class_embedding", "patch_embedding", "position_embedding"):
            out += ["embeddings", p]
        else:
            out.append(p)
    return out


def _clip_model_module(parts: List[str]) -> List[str]:
    head, rest = parts[0], parts[1:]
    if head == "text":
        return _clip_module(rest)
    if head == "vision":
        return _vision_module(rest)
    return rest  # visual_projection/visual_projection/weight -> visual_projection.weight


def _clip_module(parts: List[str]) -> List[str]:
    out = ["text_model"]
    for p in parts:
        m = _INDEXED.match(p)
        if m and m.group(1) == "layers":
            out += ["encoder", "layers", m.group(2)]
        elif p in ("token_embedding", "position_embedding"):
            out += ["embeddings", p]
        else:
            out.append(p)
    return out


def _t5_module(parts: List[str]) -> List[str]:
    head = parts[0]
    if head == "shared":
        return ["shared", "weight"]
    if head == "relative_attention_bias":
        return ["encoder", "block", "0", "layer", "0", "SelfAttention", head, "weight"]
    if head == "final_layer_norm":
        return ["encoder", "final_layer_norm", "weight"]
    m = re.match(r"^block_(\d+)$", head)
    assert m, f"unexpected T5 path {parts}"
    out = ["encoder", "block", m.group(1), "layer"]
    sub = parts[1]
    if sub in ("ln_attn", "ln_ff"):
        return out + ["0" if sub == "ln_attn" else "1", "layer_norm", parts[-1]]
    if sub == "attn":
        return out + ["0", "SelfAttention"] + parts[2:]
    return out + ["1", "DenseReluDense"] + parts[1:]  # wi_0, wi_1, wo


_MODULE_RULES = {"unet3d": _unet_module, "vae": _vae_module, "clip_text": _clip_module,
                 "raft": _raft_module, "clip_model": _clip_model_module, "t5": _t5_module,
                 "class_embedder": list}


def _unet_sd_index_map(cfg) -> Dict[str, str]:
    """The reference's Sequential prefix (``input_blocks.N.M``, ...) of each
    named UNetSD module, by walking the reference's construction order."""
    m: Dict[str, str] = {
        "input_blocks.0.0": "init_conv", "input_blocks.0.1": "init_temporal",
        "middle_block.0": "mid_res_0", "middle_block.1": "mid_spatial",
        "middle_block.2": "mid_temporal", "middle_block.3": "mid_res_1",
        "out.0": "out_norm", "out.2": "out_conv",
        "time_embed.0": "time_embed_1", "time_embed.2": "time_embed_2",
    }
    scale, idx, blk, levels = 1.0, 1, 0, len(cfg.dim_mult)
    for i in range(levels):
        for j in range(cfg.num_res_blocks):
            m[f"input_blocks.{idx}.0"] = f"down_res_{blk}"
            if scale in cfg.attn_scales:
                m[f"input_blocks.{idx}.1"] = f"down_spatial_{blk}"
                m[f"input_blocks.{idx}.2"] = f"down_temporal_{blk}"
            idx, blk = idx + 1, blk + 1
            if i != levels - 1 and j == cfg.num_res_blocks - 1:
                m[f"input_blocks.{idx}"] = f"downsample_{i}"
                idx, scale = idx + 1, scale / 2.0
    blk = 0
    for i in range(levels):
        for j in range(cfg.num_res_blocks + 1):
            base, pos = f"output_blocks.{blk}", 1
            m[f"{base}.0"] = f"up_res_{blk}"
            if scale in cfg.attn_scales:
                m[f"{base}.1"] = f"up_spatial_{blk}"
                m[f"{base}.2"] = f"up_temporal_{blk}"
                pos = 3
            if i != levels - 1 and j == cfg.num_res_blocks:
                m[f"{base}.{pos}"] = f"upsample_{i}"
                scale *= 2.0
            blk += 1
    return {v: k for k, v in m.items()}


_UNET_SD_INNER = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
                  "emb_proj": "emb_layers.1", "out_norm": "out_layers.0",
                  "out_conv": "out_layers.3", "temporal_conv": "temopral_conv",
                  "transformer_blocks_0": "transformer_blocks.0", "to_out": "to_out.0"}
_TEMPORAL = re.compile(r"^(init_temporal|mid_temporal|(down|up)_temporal_\d+)$")


def _unet_sd_state_dict(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    prefix = _unet_sd_index_map(cfg)
    sd = {}
    for path, v in flatten(params).items():
        v = np.asarray(v, dtype=np.float32)
        top, inner, leaf = path[0], list(path[1:-1]), path[-1]
        out = [prefix[top]]
        for i, p in enumerate(inner):
            if inner[i - 1:i] == ["temporal_conv"] and p[:-1] in ("norm", "conv"):
                n = p[-1]  # normN -> convN.0; convN -> convN.2 (N = 1) or convN.3
                out.append(f"conv{n}.0" if p.startswith("norm") else
                           f"conv{n}.{2 if n == '1' else 3}")
            elif p == "geglu_proj":
                out.append("net.0.proj")
            elif p == "proj_out" and inner[i - 1:i] == ["ff"]:
                out.append("net.2")
            else:
                out.append(_UNET_SD_INNER.get(p, p))
        if leaf == "kernel" and v.ndim == 3:  # temporal conv (3, I, O)
            name, v = "weight", np.transpose(v, (2, 1, 0))[..., None, None]
        elif leaf == "kernel" and inner in (["proj_in"], ["proj_out"]) and _TEMPORAL.match(top):
            name, v = "weight", np.transpose(v)[..., None]  # Conv1d k = 1
        else:
            name, v = _leaf(leaf, v)
        sd[".".join(out + [name])] = torch.tensor(v)
    return sd


def _openclip_text_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd, qkv = {}, {}
    for path, v in flatten(params).items():
        v = np.asarray(v, dtype=np.float32)
        if path == ("positional_embedding",):
            sd["positional_embedding"] = torch.tensor(v)
            continue
        parts = list(path)
        m = re.match(r"^resblocks_(\d+)$", parts[0])
        if m:
            parts[:1] = ["transformer", "resblocks", m.group(1)]
        if parts[-2] in ("q_proj", "k_proj", "v_proj"):
            base = ".".join(parts[:-2])
            qkv.setdefault((base, parts[-1]), {})[parts[-2]] = v
            continue
        if parts[-2] in ("c_fc", "c_proj"):
            parts[-2:-2] = ["mlp"]
        name, v = _leaf(parts[-1], v)
        sd[".".join(parts[:-1] + [name])] = torch.tensor(v)
    for (base, leaf), d in qkv.items():
        parts = [d[n] for n in ("q_proj", "k_proj", "v_proj")]
        packed = np.concatenate([p.T for p in parts] if leaf == "kernel" else parts, axis=0)
        sd[f"{base}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"] = torch.tensor(packed)
    return sd


def torch_state_dict_from_flax(params: Mapping[str, Any], kind: str,
                               cfg=None) -> Dict[str, torch.Tensor]:
    """A numpy (or array-like) Flax param tree -> the port module's state
    dict, as float32 CPU tensors. Each rule renames the whole key path,
    the (already renamed) leaf included. ``cfg``: the ``ModelScopeConfig``
    of a ``"unet_sd"`` tree."""
    if kind == "unet_sd":
        return _unet_sd_state_dict(params, cfg)
    if kind == "openclip_text":
        return _openclip_text_state_dict(params)
    rule = _MODULE_RULES[kind]
    sd = {}
    for path, v in flatten(params).items():
        name, val = _leaf(path[-1], np.asarray(v, dtype=np.float32))
        sd[".".join(rule(list(path[:-1]) + [name]))] = torch.tensor(val)
    if kind == "raft":
        sd.update({k.replace(".norm3.", ".downsample.1."): v for k, v in sd.items()
                   if ".norm3." in k})
    if kind == "t5":
        sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    return sd
