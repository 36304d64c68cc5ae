"""The plain operations the references are written in: float32 products
with TF32 off, over channels-last tensors, and one switch of the inputs'
precision.

``precision("fp8")`` rounds both inputs of every matrix product and
convolution to float8 e4m3 with one scale per tensor (its absolute
maximum onto 448), and in training the gradient that flows back into
each of them, with a scale of its own: the step below the bfloat16 the
program serves and trains in.
That is the control: the reference put in the program's place one
precision lower, which the comparison that decides ``correct`` has to
fail. Imports torch only.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = ["fp32"]
FP8_MAX = 448.0


def strict_fp32():
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def precision(mode: str):
    """``fp32`` (the reference) or ``fp8`` (the control) for a block."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"precision {mode!r}")
    saved, _MODE[0] = _MODE[0], mode
    try:
        yield
    finally:
        _MODE[0] = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with its absolute maximum onto 448."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8Round(torch.autograd.Function):
    """The rounding in both passes: the forward rounds the input, the
    backward the gradient that flows back into it, each with a scale of
    its own (a cast inside autograd would round the gradient with the
    input's scale, under e4m3's smallest number)."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g.float())


def q(t: torch.Tensor) -> torch.Tensor:
    """A product's input at the current precision."""
    t = t.float()
    if _MODE[0] == "fp32":
        return t
    return _Fp8Round.apply(t)


def linear(W, p: str, x, bias: bool = True):
    """``x @ W[p.weight].T + W[p.bias]``; a 1x1 conv kernel is read as its
    matrix."""
    w = W[p + ".weight"]
    w = w.reshape(w.shape[0], -1)
    b = W.get(p + ".bias") if bias else None
    return F.linear(q(x), q(w), None if b is None else b.float())


def conv(W, p: str, x, stride: int = 1, padding=1):
    """A 2D conv of ``x`` (..., H, W, C) with the leading axes as one
    batch; ``padding`` an int or F.pad's (left, right, top, bottom)."""
    lead = x.shape[:-3]
    xf = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    if not isinstance(padding, int):
        xf, padding = F.pad(xf, padding), 0
    y = F.conv2d(q(xf), q(W[p + ".weight"]), W[p + ".bias"].float(), stride, padding)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def group_norm(W, p: str, x, groups: int, eps: float, axes):
    """GroupNorm of ``x`` (..., C) with statistics over ``axes`` and the
    channels of each group."""
    c = x.shape[-1]
    g = min(groups, c)
    xg = x.float().reshape(x.shape[:-1] + (g, c // g))
    red = tuple(axes) + (xg.ndim - 1,)
    var, mean = torch.var_mean(xg, dim=red, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * W[p + ".weight"].float() + W[p + ".bias"].float()


def layer_norm(W, p: str, x, eps: float = 1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], W[p + ".weight"].float(),
                        W[p + ".bias"].float(), eps)


def attention(qt, kt, vt, scale: float, bias=None):
    """softmax(q k^T * scale + bias) v over (..., S, d)."""
    logits = torch.matmul(q(qt), q(kt).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    return torch.matmul(q(torch.softmax(logits, dim=-1)), q(vt))


def heads_attention(qt, kt, vt, heads: int, bias=None):
    """Multi-head attention on (B, S, heads*d) projections."""
    b, sq, c = qt.shape
    d = c // heads
    split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
    o = attention(split(qt), split(kt), split(vt), 1.0 / math.sqrt(d), bias)
    return o.transpose(1, 2).reshape(b, sq, c)


def upsample2x(x):
    """Nearest 2x on (..., H, W, C)."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True, shift: float = 0.0):
    """diffusers ``get_timestep_embedding`` (max period 10000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
