"""The SDXL-scale edit cell cut to a size the CPU runs in seconds: three
levels, heads 8 wide, transformer depth (0, 2, 3), both text towers and
the VAE at tiny widths."""

from __future__ import annotations

import copy

import tiny  # noqa: F401  (puts benchmark/ on the path)
from harness import Cell

EDIT_SDXL = "insv2v-sdxl.edit-16f-768-ddim20"


def tiny_sdxl_cell(dtype: str = "float32") -> Cell:
    cell = Cell.load(EDIT_SDXL)
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = dtype
    cfg["unet"].update(block_out_channels=[8, 16, 32], attention_head_dim=[1, 2, 4],
                       transformer_layers_per_block=[0, 2, 3], cross_attention_dim=16,
                       addition_time_embed_dim=8, projection_class_embeddings_input_dim=8 + 6 * 8,
                       norm_num_groups=4, motion_num_attention_heads=2)
    cfg["vae"].update(ch=8, ch_mult=[1, 2, 2, 2], num_res_blocks=1)
    cfg["text"]["clip"].update(hidden_size=8, num_layers=2, num_heads=2, intermediate_size=16)
    cfg["text"]["openclip"].update(width=8, num_layers=3, num_heads=2, projection_dim=8)
    traffic = dict(cell.traffic, frames=4, height=64, width=64, frames_per_window=4, steps=4)
    return Cell(EDIT_SDXL, dict(cell.spec), cfg, traffic)
