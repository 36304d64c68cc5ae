"""Tiny cells for the CPU tests: the published cells' traffic and
configuration shapes, cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)
for p in (ROOT, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import Cell  # noqa: E402

EDIT = "insv2v.edit-32f-256x384-ddim50"


def tiny_edit_cell() -> Cell:
    cell = Cell.load(EDIT)
    cfg = copy.deepcopy(cell.config)
    cfg["unet"].update(block_out_channels=[8, 16, 16, 16], attention_head_dim=2,
                       cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2,
                       motion_max_seq_length=8)
    cfg["vae"].update(ch=8, ch_mult=[1, 2, 2, 2], num_res_blocks=1)
    cfg["text"].update(hidden_size=12, num_layers=2, num_heads=2, intermediate_size=24)
    traffic = dict(cell.traffic, frames=8, height=64, width=64, frames_per_window=4,
                   num_ref_frames=2, steps=4)
    return Cell(EDIT, dict(cell.spec), cfg, traffic)

DATAGEN = "modelscope.ptp-v2-16f-256-ddim30"


def tiny_datagen_cell() -> Cell:
    cell = Cell.load(DATAGEN)
    cfg = copy.deepcopy(cell.config)
    cfg["unet"].update(dim=16, context_dim=16, dim_mult=[1, 2], head_dim=8, num_res_blocks=1,
                       attn_scales=[1.0, 0.5])
    cfg["vae"].update(ch=8, ch_mult=[1, 2, 2, 2], num_res_blocks=1)
    cfg["text"].update(width=16, num_layers=2, num_heads=2)
    cfg["scorer"].update(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                         image_size=28, patch_size=14, projection_dim=8)
    cfg["scorer"]["text"].update(hidden_size=12, num_layers=2, num_heads=2, intermediate_size=24)
    traffic = dict(cell.traffic, frames=4, latent_size=8, steps=6)
    return Cell(DATAGEN, dict(cell.spec), cfg, traffic)

TRAIN = "insv2v.train-16f-256-acc8"


def tiny_train_cell() -> Cell:
    cell = Cell.load(TRAIN)
    cfg = tiny_edit_cell().config
    cfg["unet"]["motion_max_seq_length"] = 32
    traffic = dict(cell.traffic, size=64, accumulate=2, samples=4)
    return Cell(TRAIN, dict(cell.spec), cfg, traffic)
