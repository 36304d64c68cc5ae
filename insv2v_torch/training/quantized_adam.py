"""Adam with int8 block-quantized moments, in plain PyTorch.

Counterpart of ``training/quantized_adam.py`` in the JAX package (the
bitsandbytes ``Adam8bit`` parity item; bitsandbytes is not a dependency).
Both moments are stored as int8 codes with one float32 absmax scale per
block of 256 values; the update runs in float32 after dequantization.
The codes are closed-form log codes: code i in [1, N] stands for
exp(ln_min + (i - 1) * step), code 0 for exactly 0, so quantizing and
dequantizing are elementwise log/exp with no table. Tensors with fewer
than ``min_quant_size`` values keep float32 moments.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "quantize_blockwise", "dequantize_blockwise", "Adam8bit"]

BLOCK = 256

# the JAX package's constants, computed in float32 as jnp computes them
_S_LNMIN = float(np.float32(math.log(1e-4)))  # signed: 127 magnitude codes
_S_STEP = -_S_LNMIN / 126.0
_U_LNMIN = float(np.float32(math.log(1e-8)))  # unsigned: 255 codes
_U_STEP = -_U_LNMIN / 254.0


def _log_code(y: torch.Tensor, ln_min: float, step: float, top: int) -> torch.Tensor:
    """Nearest-in-log-space code of y in [0, 1]; 0 below half the smallest
    representable magnitude."""
    cutoff = float(np.float32(0.5) * np.exp(np.float32(ln_min)))
    idx = torch.round(1.0 + (torch.log(y.clamp_min(cutoff)) - ln_min) / step).clamp(1, top)
    return torch.where(y < cutoff, 0, idx.to(torch.int32))


def _log_value(idx: torch.Tensor, ln_min: float, step: float) -> torch.Tensor:
    val = torch.exp(ln_min + (idx.float() - 1.0) * step)
    return torch.where(idx == 0, 0.0, val)


def quantize_blockwise(x: torch.Tensor, signed: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor -> (int8 codes (n_blocks, 256), float32 absmax scales
    (n_blocks, 1)). ``signed``: sign + 7-bit log magnitude (Adam's m);
    otherwise an 8-bit log code of a non-negative value stored biased by
    -128 (Adam's v)."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = blocks / scale
    if signed:
        mag = _log_code(y.abs(), _S_LNMIN, _S_STEP, 127)
        return (torch.sign(y) * mag.float()).to(torch.int8), scale
    codes = _log_code(y.clamp_min(0.0), _U_LNMIN, _U_STEP, 255)
    return (codes - 128).to(torch.int8), scale


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape,
                         signed: bool = True) -> torch.Tensor:
    c = codes.to(torch.int32)
    if signed:
        vals = torch.sign(c).float() * _log_value(c.abs(), _S_LNMIN, _S_STEP)
    else:
        vals = _log_value(c + 128, _U_LNMIN, _U_STEP)
    n = math.prod(shape)
    return (vals * scale).reshape(-1)[:n].reshape(shape)


class Adam8bit(torch.optim.Optimizer):
    """Adam whose moments live as int8 codes between steps; the step math
    is the JAX package's ``adam8bit`` update (optax's Adam formula)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 min_quant_size: int = 4096):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      min_quant_size=min_quant_size))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                g = p.grad.float()
                if not st:
                    st["step"] = 0
                    st["quantized"] = p.numel() >= group["min_quant_size"]
                    zeros = torch.zeros_like(g)
                    if st["quantized"]:
                        st["m"] = quantize_blockwise(zeros, signed=True)
                        st["v"] = quantize_blockwise(zeros, signed=False)
                    else:
                        st["m"], st["v"] = zeros, zeros.clone()
                st["step"] += 1
                if st["quantized"]:
                    m_prev = dequantize_blockwise(*st["m"], g.shape, signed=True)
                    v_prev = dequantize_blockwise(*st["v"], g.shape, signed=False)
                else:
                    m_prev, v_prev = st["m"], st["v"]
                m = b1 * m_prev + (1 - b1) * g
                v = b2 * v_prev + (1 - b2) * g * g
                mhat = m / (1 - b1 ** st["step"])
                vhat = v / (1 - b2 ** st["step"])
                p.add_((-lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype))
                if st["quantized"]:
                    st["m"] = quantize_blockwise(m, signed=True)
                    st["v"] = quantize_blockwise(v, signed=False)
                else:
                    st["m"], st["v"] = m, v
