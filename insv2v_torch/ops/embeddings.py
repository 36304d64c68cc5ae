"""Sinusoidal embeddings: diffusion timesteps and temporal positions.

Counterpart of ``ops/embeddings.py`` in the JAX package: diffusers
``get_timestep_embedding`` and the AnimateDiff positional-encoding table
with its sliding-window wraparound guard.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["timestep_embedding", "temporal_positional_encoding_table",
           "temporal_pe_slice"]


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """timesteps (B,) -> (B, dim) float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def temporal_positional_encoding_table(d_model: int, max_len: int = 32) -> np.ndarray:
    """(max_len, d_model) float32: pe[p, 0::2] = sin(p w_k), pe[p, 1::2] =
    cos(p w_k), w_k = exp(-ln(10000) 2k / d_model). Computed in float64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def temporal_pe_slice(pe: torch.Tensor, start_index: int, num_frames: int) -> torch.Tensor:
    """``num_frames`` rows of ``pe`` from the window's ``start_index``. A
    window that would overrun the table restarts its phase at
    ``start - max_len`` (the reference's guard); a negative start is
    clamped to 0, as in the JAX package."""
    max_len = pe.shape[0]
    start = int(start_index)
    if start + num_frames > max_len:
        start -= max_len
    start = max(start, 0)
    return pe[start: start + num_frames]
