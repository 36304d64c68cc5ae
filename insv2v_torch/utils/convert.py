"""Flax param tree -> torch state dict: the inverse of the JAX package's
``utils/convert.py`` converters, so one weight set can drive both
packages (and the JAX package's own trees can be served by the port).

``torch_state_dict_from_flax(tree, kind)`` for ``kind`` in
{"unet3d", "vae", "clip_text"} undoes ``convert_unet3d_state_dict``,
``convert_vae_state_dict`` and ``convert_clip_text_state_dict``:

  * conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw)
  * dense ``kernel`` (I, O)        -> ``weight`` (O, I)
  * norm ``scale``                 -> ``weight``; ``embedding`` -> ``weight``
  * the module renamings in reverse (``down_blocks_0`` -> ``down_blocks.0``,
    ``ff/geglu_proj`` -> ``ff.net.0.proj``, ``to_out`` -> ``to_out.0``, ...).
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


_MODULE_RULES = {"unet3d": _unet_module, "vae": _vae_module, "clip_text": _clip_module}


def torch_state_dict_from_flax(params: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """A numpy (or array-like) Flax param tree -> the port module's state
    dict, as float32 CPU tensors."""
    rule = _MODULE_RULES[kind]
    sd = {}
    for path, v in flatten(params).items():
        name, val = _leaf(path[-1], np.asarray(v, dtype=np.float32))
        key = ".".join(rule(list(path[:-1])) + [name])
        sd[key] = torch.tensor(val)
    return sd
