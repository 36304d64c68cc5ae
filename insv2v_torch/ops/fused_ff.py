"""Fused LayerNorm + GEGLU feed-forward + residual.

Counterpart of ``ops/fused_ff.py`` in the JAX package:
``x + proj_out(h * gelu(gate))`` with ``[h | gate] = geglu_proj(LN(x))``.

  * ``geglu_ff_reference``: the plain twin in stock PyTorch, exact erf
    gelu, the same composition as the JAX package's reference;
  * ``fused_geglu_ff``: kernel B (``csrc/geglu_ff.cu``) on CUDA tensors;
  * ``geglu_ff``: what the models call; the kernel wrapper on CUDA
    tensors, the plain twin on CPU tensors.

Weights are in the torch ``nn.Linear`` layout: w1 (2*inner, C),
w2 (C, inner).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from insv2v_torch.kernels import build
from insv2v_torch.ops.norms import layer_norm
from insv2v_torch.ops.recompute import KernelGrad

__all__ = ["geglu_ff_reference", "fused_geglu_ff", "geglu_ff"]

FF_WIDTHS = (320, 640, 1280)  # the SD UNet widths kernel B is compiled for


def geglu_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5):
    """LN -> Linear(2*inner) -> split -> h * gelu(gate) -> Linear(C) -> +x."""
    dt = x.dtype
    xn = layer_norm(x, ln_scale, ln_bias, eps, fused=False)  # plain whatever the switch
    h, gate = F.linear(xn, w1.to(dt), b1.to(dt)).chunk(2, dim=-1)
    h = h * F.gelu(gate, approximate="none")
    return x + F.linear(h, w2.to(dt), b2.to(dt))


def _launch_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
    c = x.shape[-1]
    inner = w2.shape[1]
    shapes = {"ln_scale": (ln_scale, (c,)), "ln_bias": (ln_bias, (c,)),
              "w1": (w1, (2 * inner, c)), "b1": (b1, (2 * inner,)),
              "w2": (w2, (c, inner)), "b2": (b2, (c,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_geglu_ff: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if c not in FF_WIDTHS or inner % 128:
        raise ValueError(f"fused_geglu_ff: C={c} is not one of the compiled widths "
                         f"{FF_WIDTHS} or inner={inner} is not a multiple of 128")
    ts = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    for t in ts:
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError("fused_geglu_ff: expects contiguous bfloat16 CUDA tensors")
        if t.data_ptr() % 16:
            raise ValueError("fused_geglu_ff: tensor data must be 16-byte aligned")
    rows = x.numel() // c
    out = torch.empty_like(x)
    status = build.load("geglu_ff").geglu_ff_fwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in ts), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(rows), ctypes.c_int(c), ctypes.c_int(inner), ctypes.c_float(eps),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    build.check("geglu_ff", status)
    fused_geglu_ff.launches += 1
    return out


def fused_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Kernel B on CUDA tensors (bf16, contiguous, C in {320, 640, 1280},
    inner % 128 == 0); the plain twin on CPU tensors. Differentiable in all
    seven tensors: the backward recomputes the plain twin."""
    if not x.is_cuda:
        return geglu_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    return KernelGrad.apply(functools.partial(_launch_ff, eps=eps),
                            functools.partial(geglu_ff_reference, eps=eps),
                            x, ln_scale, ln_bias, w1, b1, w2, b2)


fused_geglu_ff.launches = 0


def geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float = 1e-5):
    """``x + FF(LN(x))``: kernel B on CUDA tensors, the plain twin on CPU."""
    return fused_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
