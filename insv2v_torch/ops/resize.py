"""Spatial resize on channels-last tensors.

Only ``nearest_upsample_2x`` so far; the flow-warp functions of the JAX
package's ``ops/resize.py`` arrive with the flow-compensated edit.
"""

from __future__ import annotations

import torch

__all__ = ["nearest_upsample_2x"]


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Each pixel of ``x`` (..., H, W, C) becomes a 2x2 block, as torch
    ``F.interpolate(scale_factor=2, mode='nearest')`` does."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
