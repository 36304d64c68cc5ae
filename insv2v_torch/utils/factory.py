"""Build the port's {unet, vae, text_model} from a reference-style YAML
config (``configs/instruct_v2v.yaml``, or ``configs/insv2v_sdxl.yaml``
with its two text towers), with seeded random weights made directly on
the device.

Counterpart of ``utils/factory.py`` in the JAX package: the same
adapters from the reference's constructor kwargs to the config
dataclasses. The weights are random until a real checkpoint is loaded
into the modules' state dicts (the reference key layout).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import torch

from insv2v_torch._device import resolve_device
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder, DualTextEncoder
from insv2v_torch.models.openclip_text import OpenClipTextConfig, OpenClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig

__all__ = ["DEFAULT_CONFIG", "unet_config", "vae_config", "text_model", "build_models"]

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "..", "configs",
                              "instruct_v2v.yaml")


def _int_or_tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def unet_config(params: Mapping[str, Any]) -> UNetConfig:
    mm = params.get("motion_module_kwargs", {})
    d = UNetConfig()
    return UNetConfig(
        in_channels=params.get("in_channels", d.in_channels),
        out_channels=params.get("out_channels", d.out_channels),
        block_out_channels=tuple(params.get("block_out_channels", d.block_out_channels)),
        down_block_types=tuple(params.get("down_block_types", d.down_block_types)),
        up_block_types=tuple(params.get("up_block_types", d.up_block_types)),
        layers_per_block=params.get("layers_per_block", d.layers_per_block),
        attention_head_dim=_int_or_tuple(params.get("attention_head_dim",
                                                    d.attention_head_dim)),
        transformer_layers_per_block=_int_or_tuple(params.get(
            "transformer_layers_per_block", d.transformer_layers_per_block)),
        cross_attention_dim=params.get("cross_attention_dim", d.cross_attention_dim),
        use_linear_projection=params.get("use_linear_projection", d.use_linear_projection),
        addition_embed_type=params.get("addition_embed_type", d.addition_embed_type),
        addition_time_embed_dim=params.get("addition_time_embed_dim",
                                           d.addition_time_embed_dim),
        projection_class_embeddings_input_dim=params.get(
            "projection_class_embeddings_input_dim", d.projection_class_embeddings_input_dim),
        norm_num_groups=params.get("norm_num_groups", d.norm_num_groups),
        norm_eps=float(params.get("norm_eps", d.norm_eps)),
        use_motion_module=params.get("use_motion_module", d.use_motion_module),
        motion_module_resolutions=tuple(params.get("motion_module_resolutions",
                                                   d.motion_module_resolutions)),
        motion_module_mid_block=params.get("motion_module_mid_block",
                                           d.motion_module_mid_block),
        motion_num_attention_heads=mm.get("num_attention_heads",
                                          d.motion_num_attention_heads),
        motion_num_transformer_block=mm.get("num_transformer_block",
                                            d.motion_num_transformer_block),
        motion_attention_block_types=tuple(mm.get("attention_block_types",
                                                  d.motion_attention_block_types)),
        motion_max_seq_length=mm.get("temporal_position_encoding_max_len",
                                     d.motion_max_seq_length),
    )


def vae_config(params: Mapping[str, Any]) -> VaeConfig:
    dd = dict(params.get("ddconfig") or {})
    d = VaeConfig()
    return VaeConfig(
        ch=dd.get("ch", d.ch), ch_mult=tuple(dd.get("ch_mult", d.ch_mult)),
        num_res_blocks=dd.get("num_res_blocks", d.num_res_blocks),
        attn_resolutions=tuple(dd.get("attn_resolutions", d.attn_resolutions)),
        in_channels=dd.get("in_channels", d.in_channels), out_ch=dd.get("out_ch", d.out_ch),
        z_channels=dd.get("z_channels", d.z_channels),
        embed_dim=params.get("embed_dim", d.embed_dim),
        resolution=dd.get("resolution", d.resolution),
        double_z=dd.get("double_z", d.double_z))


def text_model(params: Mapping[str, Any]) -> torch.nn.Module:
    """CLIP ViT-L/14's text tower, or with ``clip`` and ``openclip`` given
    (SDXL's conditioner) the two towers as one ``DualTextEncoder``."""
    if "openclip" not in params:
        return ClipTextEncoder(ClipTextConfig.vit_l_14())
    return DualTextEncoder(ClipTextEncoder(ClipTextConfig(**params.get("clip", {}))),
                           OpenClipTextEncoder(OpenClipTextConfig(**params["openclip"])))


def build_models(config: Union[str, Mapping[str, Any]] = DEFAULT_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """{'unet', 'vae', 'text_model'} with random weights from ``seed``,
    made on ``device`` (default ``cuda``; raises without a GPU) and cast to
    ``dtype``. ``config`` is a YAML path or its loaded dict."""
    dev = resolve_device(device)
    if isinstance(config, str):
        from insv2v_torch.utils.config import load_config

        config = load_config(config)
    torch.manual_seed(seed)
    with torch.device(dev):
        models = {
            "unet": UNet3DConditionModel(unet_config(config["unet"].get("params", {}))),
            "vae": AutoencoderKL(vae_config(config["vae"].get("params", {}))),
            "text_model": text_model((config.get("text_model") or {}).get("params") or {}),
        }
    return {k: m.to(dtype).eval() for k, m in models.items()}
