"""Multi-head attention: the plain f32-softmax form, the flash kernel and
the temporal (per-pixel, over frames) kernel.

Counterpart of ``ops/attention.py`` in the JAX package. Layouts:
q (B, H, Sq, D), k and v (B, H, Sk, D), output (B, H, Sq, D).

  * ``attention``: softmax(q k^T * scale) v with f32 logits and softmax,
    stock PyTorch; serves short sequences (cross-attention over 77 text
    tokens, the S < 256 spatial levels) as XLA did for the JAX package.
  * ``flash_attention``: kernel A (``csrc/flash_attn.cu``) on CUDA tensors,
    its plain twin ``flash_attention_reference`` on CPU tensors;
    ``flash_attention_headfold`` (kernel A', the same file) is the variant
    with one block per (batch, query block) over all heads, taken when
    ``headfold`` (default ``FLASH_HEADFOLD``) is on.
  * ``temporal_attention``: kernel C (``csrc/temporal_attn.cu``) on CUDA
    tensors, ``temporal_attention_reference`` on CPU tensors.
  * ``dot_attention``/``dot_attention_bshd`` dispatch between the first
    two with the JAX package's sequence thresholds.

A CUDA tensor launches the kernel or raises; nothing falls back. The
kernel wrappers are differentiable through ``ops.recompute.KernelGrad``
(the backward recomputes the plain twin); launch counters count forward
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch

from insv2v_torch.kernels import build
from insv2v_torch.ops.recompute import KernelGrad

__all__ = ["attention", "flash_attention", "flash_attention_headfold",
           "flash_attention_reference",
           "temporal_attention", "temporal_attention_reference",
           "dot_attention", "dot_attention_bshd"]

# sequences shorter than this take the plain path (cross-attn Sk = 77,
# spatial level 2 at S = 96); the JAX package's _FLASH_MIN_SEQ/_KSEQ
FLASH_MIN_SEQ = 256
FLASH_MIN_KSEQ = 256
# head dims rounded up to 16 that the kernels are compiled for: the UNet's
# 40 and 80, ModelScope's 64 and the VAE's 512 (A), the motion modules' 40,
# 80, 160 (C)
_FLASH_HEAD_DIMS = (48, 64, 80, 512)
_FLASH_HEADFOLD_DIMS = (48, 64, 80)
# flash_attention's default kernel: A' (headfold) when on; the JAX
# package's switch and default (INSV2V_FLASH_HEADFOLD, off)
FLASH_HEADFOLD = os.environ.get("INSV2V_FLASH_HEADFOLD", "0") == "1"
_TEMPORAL_HEAD_DIMS = (16, 48, 80, 160)


def attention(q, k, v, scale: Optional[float] = None, bias=None):
    """Plain attention with f32 logits and softmax; output in q.dtype.
    ``bias`` is added to the logits (the CLIP causal mask)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    with torch.autocast(q.device.type, enabled=False):  # f32 products under autocast too
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1)
        return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention_reference(q, k, v, scale: Optional[float] = None):
    """Kernel A's plain twin: the same function in stock PyTorch."""
    return attention(q, k, v, scale)


def _check_cuda_bf16(name, *ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on the same CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: expects bfloat16 CUDA tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def _launch_flash(q, k, v, scale: float, headfold: bool):
    """One launch of kernel A, or of A' when ``headfold``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 or -(-d // 16) * 16 not in (_FLASH_HEADFOLD_DIMS if headfold else _FLASH_HEAD_DIMS):
        raise ValueError(f"flash_attention: head dim {d} is not compiled")
    _check_cuda_bf16("flash_attention", q, k, v)
    o = torch.empty_like(q)
    lib = build.load("flash_attn")
    ptrs = (ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    if headfold:
        status = lib.flash_attn_fwd_headfold(*ptrs, ctypes.c_int(b), ctypes.c_int(h),
                                             ctypes.c_int(sq), ctypes.c_int(sk),
                                             ctypes.c_int(d), ctypes.c_float(scale), stream)
        counted = flash_attention_headfold
    else:
        status = lib.flash_attn_fwd(*ptrs, ctypes.c_int(b * h), ctypes.c_int(sq),
                                    ctypes.c_int(sk), ctypes.c_int(d), ctypes.c_float(scale),
                                    stream)
        counted = flash_attention
    build.check("flash_attn", status)
    counted.launches += 1
    return o


def flash_grid(b: int, h: int, sq: int, d: int, headfold: bool) -> dict:
    """The grid that kernel A, or A' when ``headfold``, launches at
    (B, H, Sq, D) on the current CUDA device, as its launcher chooses it:
    consumer ``warpgroups`` a block, ``blocks`` launched, the work ``items``
    (query blocks of every head) they share out, the query ``rows`` of an
    item and the keys of a K/V tile (``key_tile``)."""
    out = (ctypes.c_int * 5)()
    status = build.load("flash_attn").flash_attn_grid(
        *(ctypes.c_int(x) for x in (b, h, sq, d, int(headfold))), out)
    build.check("flash_attn", status)
    return {"warpgroups": out[0], "blocks": out[1], "items": out[2], "rows": out[3],
            "key_tile": out[4]}


def flash_attention(q, k, v, scale: Optional[float] = None, headfold: Optional[bool] = None):
    """Attention through kernel A, or kernel A' when ``headfold`` (default
    ``FLASH_HEADFOLD``). q (B, H, Sq, D), k/v (B, H, Sk, D). Differentiable:
    the backward recomputes the plain twin."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    if headfold is None:
        headfold = FLASH_HEADFOLD
    # with one head (the VAE's d = 512) A's grid (B*H, Sq-blocks) already is
    # the headfold grid (B, Sq-blocks): kernel A serves that case
    if headfold and q.shape[1] > 1:
        return flash_attention_headfold(q, k, v, scale)
    return KernelGrad.apply(functools.partial(_launch_flash, scale=scale, headfold=False),
                            functools.partial(flash_attention_reference, scale=scale), q, k, v)


flash_attention.launches = 0


def flash_attention_headfold(q, k, v, scale: Optional[float] = None):
    """Attention through kernel A' (one block per (batch, query block)
    walks all heads); the plain twin on CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    return KernelGrad.apply(functools.partial(_launch_flash, scale=scale, headfold=True),
                            functools.partial(flash_attention_reference, scale=scale), q, k, v)


flash_attention_headfold.launches = 0


def temporal_attention_reference(q, k, v, scale: Optional[float] = None):
    """Kernel C's plain twin. q/k/v (B, P, F, heads, e): softmax over the F
    frames of each (pixel, head), f32 logits; output in q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bpfhe,bpghe->bphfg", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bphfg,bpghe->bpfhe", probs.float(), v.float())
    return out.to(q.dtype)


def _launch_temporal(q, k, v, scale: float):
    if q.ndim != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"temporal_attention: shapes {q.shape} {k.shape} {v.shape}")
    b, p, f, heads, e = q.shape
    if not 1 <= f <= 32:
        raise ValueError(f"temporal_attention: {f} frames, the kernel takes 1..32")
    if e % 8 or -(-e // 16) * 16 not in _TEMPORAL_HEAD_DIMS:
        raise ValueError(f"temporal_attention: head dim {e} is not compiled")
    _check_cuda_bf16("temporal_attention", q, k, v)
    o = torch.empty_like(q)
    lib = build.load("temporal_attn")
    status = lib.temporal_attn_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        ctypes.c_int(b * p), ctypes.c_int(f), ctypes.c_int(heads), ctypes.c_int(e),
        ctypes.c_float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    build.check("temporal_attn", status)
    temporal_attention.launches += 1
    return o


def temporal_grid(b: int, p: int, f: int, heads: int, e: int) -> dict:
    """The grid that kernel C launches at (B, P, F, heads, e) on the current
    CUDA device: persistent ``blocks`` of ``threads`` (a producer warp and a
    warp a head of the unit), the blocks ``resident`` an SM (the occupancy
    API), the work ``units`` of ``heads_per_unit`` heads of one pixel that
    the blocks walk, and the ring ``stages`` a block has."""
    out = (ctypes.c_int * 6)()
    status = build.load("temporal_attn").temporal_attn_grid(
        *(ctypes.c_int(x) for x in (b * p, f, heads, e)), out)
    build.check("temporal_attn", status)
    return {"blocks": out[0], "threads": out[1], "resident": out[2],
            "heads_per_unit": out[3], "units": out[4], "stages": out[5]}


def temporal_attention(q, k, v, scale: Optional[float] = None):
    """Per-(pixel, head) attention over frames through kernel C.
    q/k/v (B, P, F, heads, e); F <= 32. Differentiable: the backward
    recomputes the plain twin."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return temporal_attention_reference(q, k, v, scale)
    return KernelGrad.apply(functools.partial(_launch_temporal, scale=scale),
                            functools.partial(temporal_attention_reference, scale=scale),
                            q, k, v)


temporal_attention.launches = 0


def dot_attention(q, k, v, scale: Optional[float] = None,
                  use_flash: Optional[bool] = None):
    """Flash for long sequences (Sq, Sk >= 256), plain attention otherwise."""
    if use_flash is None:
        use_flash = q.shape[2] >= FLASH_MIN_SEQ and k.shape[2] >= FLASH_MIN_KSEQ
    if use_flash:
        return flash_attention(q, k, v, scale)
    return attention(q, k, v, scale)


def dot_attention_bshd(q, k, v, heads: int, use_flash: Optional[bool] = None):
    """Multi-head attention on the (B, S, heads*d) projection layout."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    split = lambda t, s: t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
    o = dot_attention(split(q, sq), split(k, sk), split(v, sk), 1.0 / math.sqrt(d),
                      use_flash=use_flash)
    return o.transpose(1, 2).reshape(b, sq, c)
