"""GroupNorm and LayerNorm over channels-last tensors, f32 statistics.

Counterpart of ``ops/norms.py`` in the JAX package. Which axes GroupNorm
pools over is parity-critical and chosen by the caller:

  * ``ResnetBlock3D`` normalizes the 5D video ``(B, F, H, W, C)`` with the
    default axes, so its statistics pool ACROSS frames;
  * the spatial transformer and the motion module fold frames into the
    batch first, ``(B*F, H, W, C)``, so theirs are per frame.

Statistics accumulate in float32 whatever the activation dtype, and the
affine output is computed in float32 and rounded once to the input dtype.
With a frame group (``parallel.dist.frame_parallel``), GroupNorm's
statistics over the sharded frame axis come from every rank's moments.

``group_norm_split_pair`` is the GroupNorm of a channel concat that is
never built: the up blocks' split-skip path (``models/unet3d.py``).

Both take ``silu``: the SiLU of the normalised output, as the callers'
``F.silu(norm(x))``. A call goes through kernel E
(``ops.fused_norm.fused_group_norm``: statistics, affine and SiLU in one
read and one write) when it can: no frame group, reduce axes that run
without a gap up to the channel axis, and rows that kernel E takes
(``fused_norm.group_norm_takes``: bf16 CUDA tensors, no gradient recorded
for the output). Every other call
(training's gradients, sharded frames, float32, the CPU) keeps the ATen
path below and its arithmetic, the SiLU a separate ``F.silu``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from insv2v_torch.ops.fused_norm import fused_group_norm, fused_layer_norm, group_norm_takes

__all__ = ["group_norm", "group_norm_split_pair", "layer_norm", "FUSED_LAYER_NORM"]

# layer_norm's default: kernel D when on; the JAX package's switch and
# default (INSV2V_PALLAS_NORM, off)
FUSED_LAYER_NORM = os.environ.get("INSV2V_PALLAS_NORM", "0") == "1"


def _as_rows(x: torch.Tensor, lead: int):
    """``x``'s memory as (N, M, C) rows, N the axes before ``lead`` and M
    the axes from ``lead`` to the channel axis in the order they are laid
    out (a motion module hands its output on with the frames innermost),
    and the map that lays such rows out as ``x`` is; None where those axes
    are not one dense block a sample."""
    inner = sorted(range(lead, x.ndim - 1), key=lambda a: -x.stride(a))
    order = list(range(lead)) + inner + [x.ndim - 1]
    xp = x.permute(order)
    if not xp.is_contiguous():
        return None
    back = [order.index(a) for a in range(x.ndim)]
    rows = xp.reshape(math.prod(x.shape[:lead]), -1, x.shape[-1])
    return rows, lambda y: y.reshape(xp.shape).permute(back)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    reduce_axes: Optional[Sequence[int]] = None,
    group=None,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm of ``x`` (..., C), then its SiLU with ``silu``.
    ``reduce_axes`` defaults to every axis except the batch axis 0 and the
    channel axis. ``group``: a ``parallel.dist.Group`` over whose ranks one
    of the reduced axes is sharded; the statistics are then every rank's
    (one all-reduce of the per-group sum, sum of squares and count, in
    float64)."""
    c = x.shape[-1]
    assert c % num_groups == 0, f"channels {c} not divisible by groups {num_groups}"
    if reduce_axes is None:
        reduce_axes = tuple(range(1, x.ndim - 1))
    lead = min((a % x.ndim for a in reduce_axes), default=x.ndim - 1)
    if sorted(a % x.ndim for a in reduce_axes) == list(range(lead, x.ndim - 1)):
        rows = _as_rows(x, lead)
        if rows is not None and group is None \
                and group_norm_takes(rows[:1], scale, bias, num_groups):
            return rows[1](fused_group_norm(rows[:1], scale, bias, num_groups, eps, silu)[0])
    y = _group_norm_aten(x, scale, bias, num_groups, eps, reduce_axes, group)
    return F.silu(y) if silu else y


def _group_norm_aten(x, scale, bias, num_groups, eps, reduce_axes, group):
    c = x.shape[-1]
    xg = x.reshape(x.shape[:-1] + (num_groups, c // num_groups))
    axes = tuple(reduce_axes) + (xg.ndim - 1,)
    if group is None:
        var, mean = torch.var_mean(xg.float(), dim=axes, unbiased=False, keepdim=True)
    else:
        mean, var = _moments_over_ranks(xg, axes, group)
    # y = (x - mean) * rstd * scale + bias = x * a + b, with the per-group
    # (a, b) in f32: one pass over x that computes in f32 and writes x.dtype
    a = torch.rsqrt(var + eps) * scale.float().reshape(num_groups, -1)
    b = bias.float().reshape(num_groups, -1) - mean * a
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad):
        # autograd does not record out= ops: the same f32 affine, rounded after
        return torch.addcmul(b, xg, a).to(x.dtype).reshape(x.shape)
    return torch.addcmul(b, xg, a, out=torch.empty_like(xg)).reshape(x.shape)


def _sum_over_ranks(moments: torch.Tensor, group) -> torch.Tensor:
    """The float64 ``moments`` (sums, sums of squares, count) summed over
    ``group``'s ranks: the one all-reduce of a sharded GroupNorm."""
    return group.all_reduce_sum(moments)


def _moments_over_ranks(xg, axes, group):
    """(mean, var) in float32 over ``axes`` of every rank's ``xg``."""
    xd = xg.double()
    count = torch.full((1,), float(math.prod(xg.shape[a] for a in axes)), dtype=torch.float64,
                       device=xg.device)
    s1, s2 = xd.sum(dim=axes, keepdim=True), xd.square().sum(dim=axes, keepdim=True)
    moments = _sum_over_ranks(torch.cat([s1.reshape(-1), s2.reshape(-1), count]), group)
    n = moments[-1]
    mean = moments[:s1.numel()].reshape(s1.shape) / n
    var = (moments[s1.numel():-1].reshape(s1.shape) / n - mean * mean).clamp_min(0.0)
    return mean.float(), var.float()


def group_norm_split_pair(
    x: torch.Tensor,
    skip: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    group=None,
    silu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm of the virtual ``concat([x, skip], -1)``, without building
    the concat: ``(x_n, skip_n)``, each in its own dtype, with ``silu``
    each part's SiLU. Where kernel E takes the call (module docstring) it
    normalises both parts in one launch; otherwise as follows.

    Per-part channel sums and sums of squares over every axis but the batch
    axis 0 and the channel axis (the across-frames statistics of
    ``ResnetBlock3D``), in float32, are combined into per-group statistics
    with the one-pass variance ``E[x^2] - mean^2`` clamped at 0 (the
    two-pass form cannot compose across the parts). Groups may straddle
    the boundary between the parts (1280 + 640 channels in 32 groups of
    60). The affine is folded into one per-channel scale and offset, and
    each part is written in one float32 pass rounded to its dtype.

    ``group``: a ``parallel.dist.Group`` over whose ranks the frame axis is
    sharded; both parts' moments and the count then go through one
    all-reduce in float64."""
    assert x.shape[:-1] == skip.shape[:-1], (x.shape, skip.shape)
    c1, c2 = x.shape[-1], skip.shape[-1]
    ct = c1 + c2
    assert ct % num_groups == 0, f"channels {ct} not divisible by groups {num_groups}"
    # the statistics pool every row and the affine is per channel, so the
    # parts' rows need not be laid out alike
    rx, rs = _as_rows(x, 1), _as_rows(skip, 1)
    if rx is not None and rs is not None and group is None \
            and group_norm_takes((rx[0], rs[0]), scale, bias, num_groups):
        xn, sn = fused_group_norm((rx[0], rs[0]), scale, bias, num_groups, eps, silu)
        return rx[1](xn), rs[1](sn)
    gs = ct // num_groups
    red = tuple(range(1, x.ndim - 1))
    b = x.shape[0]
    acc = torch.float32 if group is None else torch.float64
    # per-channel sums and sums of squares (squared 2-norms) of each part
    s = torch.cat([torch.sum(p, dim=red, dtype=acc) for p in (x, skip)], -1)
    q = torch.cat([torch.linalg.vector_norm(p, dim=red, dtype=acc).square()
                   for p in (x, skip)], -1)
    n = float(gs * math.prod(x.shape[a] for a in red))
    if group is not None:
        moments = _sum_over_ranks(torch.cat([s.reshape(-1), q.reshape(-1), s.new_full((1,), n)]),
                                  group)
        s, q, n = moments[:b * ct], moments[b * ct:-1], moments[-1]
    s, q = s.reshape(b, num_groups, gs).sum(-1), q.reshape(b, num_groups, gs).sum(-1)
    mean = s / n
    var = (q / n - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var.float() + eps).repeat_interleave(gs, dim=-1)  # (B, C_total)
    # out = p * sc + off, with sc = inv * scale and off = bias - mean * sc
    sc = inv * scale.float()
    off = bias.float() - mean.float().repeat_interleave(gs, dim=-1) * sc
    bshape = (b,) + (1,) * len(red)

    def apply(p, lo, hi):
        a, o = sc[:, lo:hi].reshape(bshape + (hi - lo,)), off[:, lo:hi].reshape(bshape + (hi - lo,))
        if torch.is_grad_enabled() and (p.requires_grad or a.requires_grad):
            return torch.addcmul(o, p, a).to(p.dtype)
        return torch.addcmul(o, p, a, out=torch.empty_like(p))

    xn, sn = apply(x, 0, c1), apply(skip, c1, ct)
    return (F.silu(xn), F.silu(sn)) if silu else (xn, sn)


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
    # under autocast F.layer_norm computes and returns float32: round to x's dtype
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype), bias.to(x.dtype), eps).to(x.dtype)
