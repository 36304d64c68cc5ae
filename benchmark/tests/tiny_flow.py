"""The motion-compensated edit cell cut to a size the CPU runs in seconds:
the tiny edit cell's models and windows (8 frames at 64 x 64, windows of 4
with 2 refs, so three windows and 8 RAFT pairs), DDPM 4 steps, and RAFT at
``RaftConfig.tiny()``'s widths."""

from __future__ import annotations

import copy

import tiny  # noqa: F401  (puts benchmark/ on the path)
from harness import Cell

EDIT_FLOW = "insv2v.edit-flow-raft-32f-384-ddpm20"
TINY_RAFT = dict(feature_dim=32, hidden_dim=16, context_dim=16, corr_levels=2, corr_radius=2,
                 iters=3, base_width=8)


def tiny_flow_cell(dtype: str = "float32") -> Cell:
    cell = Cell.load(EDIT_FLOW)
    edit = tiny.tiny_edit_cell()
    cfg = copy.deepcopy(cell.config)
    cfg.update(dtype=dtype, unet=edit.config["unet"], vae=edit.config["vae"],
               text=edit.config["text"])
    cfg["flow"] = dict(cfg["flow"], **TINY_RAFT)
    traffic = dict(cell.traffic, frames=8, height=64, width=64, frames_per_window=4,
                   num_ref_frames=2, steps=4)
    return Cell(EDIT_FLOW, dict(cell.spec), cfg, traffic)
