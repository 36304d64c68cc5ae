"""GroupNorm and LayerNorm over channels-last tensors, f32 statistics.

Counterpart of ``ops/norms.py`` in the JAX package. Which axes GroupNorm
pools over is parity-critical and chosen by the caller:

  * ``ResnetBlock3D`` normalizes the 5D video ``(B, F, H, W, C)`` with the
    default axes, so its statistics pool ACROSS frames;
  * the spatial transformer and the motion module fold frames into the
    batch first, ``(B*F, H, W, C)``, so theirs are per frame.

Statistics accumulate in float32 whatever the activation dtype, and the
affine output is computed in float32 and rounded once to the input dtype.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from insv2v_torch.ops.fused_norm import fused_layer_norm

__all__ = ["group_norm", "layer_norm", "FUSED_LAYER_NORM"]

# layer_norm's default: kernel D when on; the JAX package's switch and
# default (INSV2V_PALLAS_NORM, off)
FUSED_LAYER_NORM = os.environ.get("INSV2V_PALLAS_NORM", "0") == "1"


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    reduce_axes: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """GroupNorm of ``x`` (..., C). ``reduce_axes`` defaults to every axis
    except the batch axis 0 and the channel axis."""
    c = x.shape[-1]
    assert c % num_groups == 0, f"channels {c} not divisible by groups {num_groups}"
    if reduce_axes is None:
        reduce_axes = tuple(range(1, x.ndim - 1))
    xg = x.reshape(x.shape[:-1] + (num_groups, c // num_groups))
    axes = tuple(reduce_axes) + (xg.ndim - 1,)
    var, mean = torch.var_mean(xg.float(), dim=axes, unbiased=False, keepdim=True)
    # y = (x - mean) * rstd * scale + bias = x * a + b, with the per-group
    # (a, b) in f32: one pass over x that computes in f32 and writes x.dtype
    a = torch.rsqrt(var + eps) * scale.float().reshape(num_groups, -1)
    b = bias.float().reshape(num_groups, -1) - mean * a
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad):
        # autograd does not record out= ops: the same f32 affine, rounded after
        return torch.addcmul(b, xg, a).to(x.dtype).reshape(x.shape)
    return torch.addcmul(b, xg, a, out=torch.empty_like(xg)).reshape(x.shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, fused: Optional[bool] = None) -> torch.Tensor:
    """LayerNorm over the last axis. ``fused`` (default ``FUSED_LAYER_NORM``)
    goes through ``fused_layer_norm`` (kernel D on CUDA tensors, f32 scale
    and bias); otherwise PyTorch's fused op, which keeps the statistics and
    the affine in f32 for bf16 inputs."""
    if fused is None:
        fused = FUSED_LAYER_NORM
    if fused:
        return fused_layer_norm(x, scale, bias, eps)
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype), bias.to(x.dtype), eps)
