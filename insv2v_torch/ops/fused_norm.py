"""Row-wise LayerNorm through kernel D, channels-last GroupNorm (+ SiLU)
through kernel E.

Counterpart of ``ops/fused_norm.py`` in the JAX package (its Pallas
``_ln_kernel``, taken when ``INSV2V_PALLAS_NORM=1``):

  * ``fused_layer_norm_reference``: the plain twin, the same arithmetic
    as ``_ln_kernel``: f32 mean, then the centred variance, f32 scale and
    bias, one rounding to x.dtype;
  * ``fused_layer_norm``: kernel D (``csrc/layer_norm.cu``) on CUDA
    tensors, the twin on CPU tensors. ``ops.norms.layer_norm`` calls it
    when its ``fused`` switch is on.

Kernel E has no Pallas counterpart (the JAX package leaves GroupNorm to
XLA):

  * ``fused_group_norm_reference``: the plain twin: GroupNorm of the
    channel concat of one or two (N, M, C_p) parts, statistics per
    (n, group) over the M rows, f32 mean and centred variance, f32 affine,
    SiLU when asked for, one rounding a part;
  * ``fused_group_norm``: kernel E (``csrc/group_norm.cu``) on CUDA
    tensors, the twin on CPU tensors. ``ops.norms.group_norm`` and
    ``group_norm_split_pair`` call it for the calls it takes.
"""

from __future__ import annotations

import ctypes
import functools

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from insv2v_torch.kernels import build
from insv2v_torch.ops.recompute import KernelGrad

__all__ = ["fused_layer_norm", "fused_layer_norm_reference", "layer_norm_grid",
           "fused_group_norm", "fused_group_norm_reference", "group_norm_plan",
           "group_norm_rpar", "group_norm_grid", "group_norm_takes",
           "GN_MAX_WIDTH"]

LN_MAX_WIDTH = 1280  # the widest row kernel D keeps in one warp's registers
GN_MAX_WIDTH = 4096  # kernel E: channels of both parts, 8 a thread, 512 threads a block


def fused_layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis in float32, rounded once to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _launch_ln(x, scale, bias, eps: float):
    c = x.shape[-1]
    if c % 8 or c > LN_MAX_WIDTH:
        raise ValueError(f"fused_layer_norm: width {c} is not a multiple of 8 up to "
                         f"{LN_MAX_WIDTH}")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"fused_layer_norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("fused_layer_norm: expects a contiguous bfloat16 CUDA tensor")
    # the kernel reads the affine in f32, as _ln_kernel does (C values)
    s32, b32 = scale.float().contiguous(), bias.float().contiguous()
    for t in (x, s32, b32):
        if t.device != x.device:
            raise ValueError("fused_layer_norm: all inputs must be on the same CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("fused_layer_norm: tensor data must be 16-byte aligned")
    y = torch.empty_like(x)
    status = build.load("layer_norm").layer_norm_fwd(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(s32.data_ptr()),
        ctypes.c_void_p(b32.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_int(x.numel() // c), ctypes.c_int(c), ctypes.c_float(eps),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    build.check("layer_norm", status)
    fused_layer_norm.launches += 1
    return y


def layer_norm_grid(rows: int, c: int) -> dict:
    """The grid that kernel D launches at (rows, C) on the current CUDA
    device: ``blocks`` of ``threads`` (one warp a row) and the blocks
    ``resident`` an SM (the occupancy API)."""
    out = (ctypes.c_int * 3)()
    status = build.load("layer_norm").layer_norm_grid(ctypes.c_int(rows), ctypes.c_int(c), out)
    build.check("layer_norm", status)
    return {"blocks": out[0], "threads": out[1], "resident": out[2]}


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis through kernel D (x bf16, C % 8 == 0,
    C <= 1280); the plain twin on CPU tensors. Differentiable in x, scale
    and bias: the backward recomputes the plain twin."""
    if not x.is_cuda:
        return fused_layer_norm_reference(x, scale, bias, eps)
    return KernelGrad.apply(functools.partial(_launch_ln, eps=eps),
                            functools.partial(fused_layer_norm_reference, eps=eps),
                            x, scale, bias)


fused_layer_norm.launches = 0


def fused_group_norm_reference(parts: Sequence[torch.Tensor], scale, bias, num_groups: int,
                               eps: float = 1e-6, silu: bool = False) -> Tuple[torch.Tensor, ...]:
    """GroupNorm (then SiLU, with ``silu``) of the channel concat of
    ``parts``, each (N, M, C_p): statistics per (n, group) over the M rows
    and the group's channels in float32, one output a part in its dtype."""
    xf = torch.cat([p.float() for p in parts], -1)
    n, m, c = xf.shape
    xg = xf.reshape(n, m, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, m, c) * scale.float() + bias.float()
    if silu:
        y = F.silu(y)
    return tuple(t.to(p.dtype) for t, p in zip(y.split([p.shape[-1] for p in parts], -1), parts))


def group_norm_rpar(c: int) -> int:
    """Rows a block of kernel E reads at once for C channels: C / 8 * rpar
    threads (8 channels a thread), about 256."""
    v = c // 8
    return max(1, (256 + v // 2) // v)


def group_norm_plan(n: int, m: int, c: int, slots: int) -> Tuple[int, int, int]:
    """Kernel E's blocks for N samples of M rows of C channels where
    ``slots`` blocks are resident at once (SMs times blocks an SM):
    ``(rpar, rows, chunks)``. A block reads ``rows`` rows of one sample,
    ``rpar`` at a time; a sample takes ``chunks`` blocks. The rows are the
    fewest (at least 8 a thread) whose N * chunks blocks fill whole waves
    of the slots with at most 64 rows a thread, so no short last wave
    doubles a pass."""
    rpar = group_norm_rpar(c)
    waves = max(1, -(-n * m // (rpar * slots * 64)))
    per_thread = max(8, -(-n * m // (rpar * slots * waves)))
    while n * -(-m // (rpar * per_thread)) > slots * waves:
        per_thread += 1
    rows = rpar * per_thread
    return rpar, rows, -(-m // rows)


@functools.lru_cache(maxsize=None)
def _slots(index: int, c: int) -> int:
    """Blocks of kernel E resident at once on CUDA device ``index`` for C
    channels: its SMs times the fewer of the stats and apply kernels'
    blocks an SM."""
    with torch.cuda.device(index):
        grid = group_norm_grid(c, group_norm_rpar(c))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * max(1, min(grid["resident_stats"], grid["resident_apply"]))


def group_norm_grid(c: int, rpar: int) -> dict:
    """The block kernel E launches for C channels at ``rpar`` rows, on the
    current CUDA device: its ``threads`` and the blocks of the stats and
    the apply kernels ``resident`` an SM (the occupancy API)."""
    out = (ctypes.c_int * 3)()
    status = build.load("group_norm").group_norm_grid(ctypes.c_int(c), ctypes.c_int(rpar), out)
    build.check("group_norm", status)
    return {"threads": out[0], "resident_stats": out[1], "resident_apply": out[2]}


def _refusal(parts, scale, bias, num_groups: int):
    """Why kernel E does not take the GroupNorm of ``parts`` in
    ``num_groups`` groups with ``scale`` and ``bias``, as the error its
    wrapper raises; None where it takes it."""
    if len(parts) not in (1, 2):
        return ValueError(f"fused_group_norm: one or two parts, not {len(parts)}")
    x = parts[0]
    for p in parts:
        if not p.is_cuda or p.dtype != torch.bfloat16 or not p.is_contiguous() or p.ndim != 3:
            return TypeError("fused_group_norm: expects contiguous (N, M, C) bfloat16 CUDA parts")
        if p.shape[:2] != x.shape[:2] or p.device != x.device:
            return ValueError("fused_group_norm: the parts must share N, M and the device")
        if p.shape[-1] % 8 or p.data_ptr() % 16:
            return ValueError(f"fused_group_norm: a part of {p.shape[-1]} channels: each needs a "
                              "multiple of 8 channels and 16-byte aligned data")
    n = x.shape[0]
    c = sum(p.shape[-1] for p in parts)
    if num_groups < 1 or c % num_groups or c > GN_MAX_WIDTH or n > 65535:
        return ValueError(f"fused_group_norm: {c} channels in {num_groups} groups, {n} samples "
                          f"(at most {GN_MAX_WIDTH} channels, 65535 samples)")
    for t in (scale, bias):
        if tuple(t.shape) != (c,) or t.device != x.device or not t.is_contiguous() \
                or t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != scale.dtype:
            return ValueError(f"fused_group_norm: scale and bias must be contiguous ({c},) "
                              "float32 or bfloat16 tensors of one dtype on the parts' device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*parts, scale, bias)):
        return ValueError("fused_group_norm: kernel E has no backward; call it where no "
                          "gradient is recorded")
    return None


def group_norm_takes(parts: Sequence[torch.Tensor], scale, bias, num_groups: int) -> bool:
    """Whether kernel E takes the GroupNorm of ``parts`` (the conditions of
    ``fused_group_norm``, which raises on CUDA parts it does not take)."""
    return _refusal(tuple(parts), scale, bias, num_groups) is None


def _launch_gn(parts, scale, bias, num_groups: int, eps: float, silu: bool):
    err = _refusal(parts, scale, bias, num_groups)
    if err is not None:
        raise err
    x = parts[0]
    n, m = x.shape[:2]
    c = sum(p.shape[-1] for p in parts)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rpar, rows, chunks = group_norm_plan(n, m, c, _slots(index, c))
    outs = [torch.empty_like(p) for p in parts]
    scratch = torch.empty(n * num_groups * (chunks + 1) * 2, dtype=torch.float32,
                          device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    two = len(parts) == 2
    status = build.load("group_norm").group_norm_fwd(
        ptr(x), ptr(parts[1]) if two else None, ptr(scale), ptr(bias), ptr(outs[0]),
        ptr(outs[1]) if two else None, ptr(scratch), ctypes.c_int(n), ctypes.c_int(m),
        ctypes.c_int(x.shape[-1]), ctypes.c_int(parts[1].shape[-1] if two else 0),
        ctypes.c_int(num_groups), ctypes.c_int(rpar), ctypes.c_int(rows), ctypes.c_int(chunks),
        ctypes.c_int(scale.dtype == torch.bfloat16), ctypes.c_float(eps), ctypes.c_int(silu),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    build.check("group_norm", status)
    fused_group_norm.launches += 1
    return tuple(outs)


def fused_group_norm(parts: Sequence[torch.Tensor], scale, bias, num_groups: int,
                     eps: float = 1e-6, silu: bool = False) -> Tuple[torch.Tensor, ...]:
    """GroupNorm (then SiLU, with ``silu``) of the channel concat of the
    one or two (N, M, C_p) ``parts``, never built: statistics per
    (n, group) over the M rows and the group's channels, which may straddle
    the parts; one output a part. Kernel E on CUDA parts (bf16, each C_p a
    multiple of 8, C <= 4096 in all; scale and bias (C,) in float32 or
    bf16; no gradient recorded: E has no backward), the plain twin on CPU
    parts. One launch counted a call."""
    parts = tuple(parts)
    if not parts[0].is_cuda:
        return fused_group_norm_reference(parts, scale, bias, num_groups, eps, silu)
    return _launch_gn(parts, scale, bias, num_groups, eps, silu)


fused_group_norm.launches = 0
