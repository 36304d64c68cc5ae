"""The launches of kernels A, B and C in one call of the SDXL-scale UNet3D
(``configs/insv2v-sdxl-animatediff.json``), reckoned from the
configuration and the call's shapes with the work of each launch as
``kernels.py`` counts it: heads and transformer depth given a level, the
mid block at the last level's."""

from __future__ import annotations

from typing import Dict, List

from work.kernels import Work, flash, geglu_ff, temporal


def unet3d_xl_launches(cfg: dict, batch: int, frames: int, h: int, w: int,
                       flash_min_seq: int = 256) -> Dict[str, List[Work]]:
    """A for every spatial self-attention at S >= ``flash_min_seq``
    positions (heads of ``C / heads`` wide), B for every spatial block's
    and every motion module's FF, C twice in every motion module."""
    ch = cfg["block_out_channels"]
    heads, depth = cfg["attention_head_dim"], cfg["transformer_layers_per_block"]
    mheads = cfg["motion_num_attention_heads"]
    n = len(ch)
    out: Dict[str, List[Work]] = {"flash": [], "ff": [], "temporal": []}
    res = cfg["motion_module_resolutions"]
    motion = lambda level: cfg["use_motion_module"] and 2 ** level in res
    bf = batch * frames

    def level(lvl: int, cross: bool, mm: bool, count: int):
        c, s = ch[lvl], (h >> lvl) * (w >> lvl)
        for _ in range(count):
            if cross:
                for _ in range(depth[lvl]):
                    if s >= flash_min_seq:
                        out["flash"].append(flash(bf, heads[lvl], s, s, c // heads[lvl]))
                    out["ff"].append(geglu_ff(bf * s, c, 4 * c))
            if mm:
                out["ff"].append(geglu_ff(bf * s, c, 4 * c))
                for _ in cfg["motion_attention_block_types"]:
                    out["temporal"].append(temporal(batch * s, frames, mheads, c // mheads))

    for i, kind in enumerate(cfg["down_block_types"]):
        level(i, kind.startswith("CrossAttn"), motion(i), cfg["layers_per_block"])
    level(n - 1, True, False, 1)  # the mid block's transformer
    for i, kind in enumerate(cfg["up_block_types"]):
        level(n - 1 - i, kind.startswith("CrossAttn"), motion(n - 1 - i),
              cfg["layers_per_block"] + 1)
    return out
