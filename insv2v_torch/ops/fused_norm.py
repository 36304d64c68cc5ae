"""Row-wise LayerNorm through kernel D.

Counterpart of ``ops/fused_norm.py`` in the JAX package (its Pallas
``_ln_kernel``, taken when ``INSV2V_PALLAS_NORM=1``):

  * ``fused_layer_norm_reference``: the plain twin, the same arithmetic
    as ``_ln_kernel``: f32 mean, then the centred variance, f32 scale and
    bias, one rounding to x.dtype;
  * ``fused_layer_norm``: kernel D (``csrc/layer_norm.cu``) on CUDA
    tensors, the twin on CPU tensors. ``ops.norms.layer_norm`` calls it
    when its ``fused`` switch is on.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from insv2v_torch.kernels import build
from insv2v_torch.ops.recompute import KernelGrad

__all__ = ["fused_layer_norm", "fused_layer_norm_reference"]

LN_MAX_WIDTH = 1280  # the widest row kernel D keeps in one warp's registers


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
