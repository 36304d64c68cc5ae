"""Gradients through the hand-written kernels.

The JAX package gives none of its Pallas kernels a backward kernel: each
sits in a ``jax.custom_vjp`` whose backward recomputes the plain form and
takes its VJP (``ops/attention.py`` ``_flash_bwd`` and
``_packed_temporal_bwd``, ``ops/fused_ff.py`` ``_ff_bwd``). ``KernelGrad``
is that rule as a ``torch.autograd.Function``: the forward launches the
kernel, the backward reruns the kernel's plain twin on the saved inputs
under autograd and returns its gradients.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["KernelGrad"]


class KernelGrad(torch.autograd.Function):
    """``KernelGrad.apply(kernel, twin, *tensors)``: ``kernel(*tensors)``
    forward, the gradient of ``twin(*tensors)`` backward. Both callables
    take the tensors positionally and return one tensor."""

    @staticmethod
    def forward(ctx, kernel: Callable, twin: Callable, *tensors):
        ctx.twin = twin
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.twin(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, needs) if n],
                                             grad))
        return (None, None, *(next(grads) if n else None for n in needs))
