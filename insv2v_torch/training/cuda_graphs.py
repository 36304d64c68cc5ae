"""The trainer's UNet call replayed from captured CUDA graphs.

A training run's microbatch has the same shapes every time, so on a CUDA
device ``GraphedCall`` captures the UNet's training forward, and its
backward to the trainable parameters, once for each key and replays both
for every later call: the host no longer dispatches the forward, remat's
reruns and the backward op by op. It is the rule of
``torch.cuda.make_graphed_callables``:

  * an autograd ``Function`` (``_Replay``) whose forward copies the call's
    tensors into static inputs and replays the forward graph, and whose
    backward copies the incoming gradient into a static buffer and replays
    the backward graph, which yields the trainable parameters' gradients;
  * the two graphs of a key share one private memory pool; the parameters
    are read in place, so an in-place update between replays (the
    trainer's ``push_params``) is what the next replay sees;
  * before the capture, one forward and backward on the capture stream
    warm up what initialises lazily (kernel libraries, cuBLAS workspaces);
    the capture runs in ``thread_local`` mode, so another thread (the
    prefetch loader pinning host memory) may call into CUDA meanwhile;
  * under autocast, the forward's warm-up and capture run under the same
    autocast with its weight cache off (a cast cached outside the graph
    would be read stale inside it), and the backward's without autocast,
    where the trainer runs its backward (autograd carries its caller's
    autocast state into the backward).

The key is what the call can observe: the inputs' shapes and dtypes, the
device, the autocast state, every parameter's and buffer's storage and
``requires_grad``, every submodule's train/eval flag, the module's
``cfg`` (the UNet's, remat among it) and the kernels' dispatch switches
(``attention.FLASH_HEADFOLD``, ``norms.FUSED_LAYER_NORM``). A new key
captures anew, and a reallocated parameter can never be read through an
old graph. A graph reads device memory only: a buffer left on the host
fails the capture. A CPU tensor, a call without gradient recording, or
an input that requires grad is called as it is.

Static buffers. The prediction a call returns and the gradients its
backward hands on are views of the graphs' static buffers, which the next
replay of the key overwrites: run one call's backward before the next
call, and consume its gradients at once (the trainer adds them into its
accumulators before the next microbatch).

Launch counters. The kernel wrappers count their launches in Python
(``.launches``), which a replay does not pass through. A capture records
each counter's advance during the forward capture and during the backward
capture (remat's reruns included) and sets the counters back, as a capture
launches nothing; every replay adds those advances. A replayed call
therefore leaves the counters as the eager call does; the warm-up, which
does launch, counts as an eager call.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

import torch

from insv2v_torch.ops import attention, norms
from insv2v_torch.utils.tracing import kernel_wrappers, span

__all__ = ["GraphedCall", "Captured", "counted_capture", "add_launches"]

T = TypeVar("T")


def counted_capture(capture: Callable[[], T]) -> Tuple[T, Dict[str, int]]:
    """``capture()`` with the launch counters set back after it, and what
    it would have added to each: a capture launches nothing."""
    fns = kernel_wrappers()
    before = [f.launches for f in fns]
    try:
        out = capture()
        return out, {f.__name__: f.launches - b for f, b in zip(fns, before)}
    finally:
        for f, b in zip(fns, before):
            f.launches = b


def add_launches(advance: Dict[str, int]) -> None:
    """Add a replay's launches, as its capture recorded them, to the
    counters."""
    for f in kernel_wrappers():
        f.launches += advance.get(f.__name__, 0)


class Captured:
    """One key's captured forward and backward: the graphs (anything with
    ``replay()``), the static inputs, output, incoming gradient and
    parameter gradients they read and write, and each graph's advance of
    the launch counters."""

    def __init__(self, fwd, bwd, inputs: Sequence[torch.Tensor], output: torch.Tensor,
                 grad_output: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
                 fwd_launches: Dict[str, int], bwd_launches: Dict[str, int]):
        self.fwd, self.bwd = fwd, bwd
        self.inputs, self.output, self.grad_output = list(inputs), output, grad_output
        self.grads = tuple(grads)
        self.fwd_launches, self.bwd_launches = fwd_launches, bwd_launches

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        with span("train.graph_replay"):
            self.fwd.replay()
        add_launches(self.fwd_launches)
        return self.output.detach()

    def backward(self, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        self.grad_output.copy_(grad)
        self.bwd.replay()
        add_launches(self.bwd_launches)
        return tuple(None if g is None else g.detach() for g in self.grads)


class _Replay(torch.autograd.Function):
    """``_Replay.apply(captured, *inputs, *params)``: the captured forward;
    its backward gives the parameters their captured gradients."""

    @staticmethod
    def forward(ctx, captured: Captured, *tensors):
        ctx.captured = captured
        ctx.n_inputs = len(captured.inputs)
        return captured.forward(*tensors[:ctx.n_inputs])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (None, *([None] * ctx.n_inputs), *ctx.captured.backward(grad))


def _uncached_autocast(device_type: str):
    """The ambient autocast of ``device_type`` with its weight cache off."""
    if not torch.is_autocast_enabled(device_type):
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=torch.get_autocast_dtype(device_type),
                          cache_enabled=False)


class GraphedCall:
    """``fn(*inputs)``, differentiable in ``module``'s parameters that
    require grad, replayed on a CUDA device from graphs captured once a
    key (the module docstring)."""

    def __init__(self, fn: Callable[..., torch.Tensor], module: torch.nn.Module):
        self.fn, self.module = fn, module
        self.captured: Dict[tuple, Captured] = {}
        self.stream: Optional[torch.cuda.Stream] = None

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        if (not inputs[0].is_cuda or not torch.is_grad_enabled()
                or any(x.requires_grad for x in inputs)):
            return self.fn(*inputs)
        params = [p for p in self.module.parameters() if p.requires_grad]
        key = self._key(inputs)
        captured = self.captured.get(key)
        if captured is None:
            with span("train.graph_capture"):
                captured = self.captured[key] = self._capture(inputs, params)
        return _Replay.apply(captured, *inputs, *params)

    def _key(self, inputs) -> tuple:
        dev = inputs[0].device
        state = [(t.data_ptr(), t.requires_grad)
                 for t in (*self.module.parameters(), *self.module.buffers())]
        return (tuple((x.shape, x.dtype) for x in inputs), dev,
                torch.is_autocast_enabled(dev.type), torch.get_autocast_dtype(dev.type),
                tuple(state), tuple(m.training for m in self.module.modules()),
                getattr(self.module, "cfg", None), attention.FLASH_HEADFOLD,
                norms.FUSED_LAYER_NORM)

    def _capture(self, inputs, params) -> Captured:
        dev = inputs[0].device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side, ambient = self.stream, torch.cuda.current_stream(dev)
        static = [x.detach().clone() for x in inputs]
        fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        graph = lambda g: torch.cuda.graph(g, pool=pool, stream=side,
                                           capture_error_mode="thread_local")
        # autograd runs a backward under its caller's autocast state: the
        # backward is warmed up and captured without autocast, as the
        # trainer calls it
        no_autocast = lambda: torch.autocast(dev.type, enabled=False)
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            with _uncached_autocast(dev.type):
                out = self.fn(*static)
            with no_autocast():
                torch.autograd.grad(out, params, torch.zeros_like(out), allow_unused=True)
            del out
        ambient.wait_stream(side)

        def forward():
            with _uncached_autocast(dev.type), graph(fwd):
                return self.fn(*static)

        def backward():
            with no_autocast(), graph(bwd):
                return torch.autograd.grad(out, params, grad_output, allow_unused=True)

        out, fwd_launches = counted_capture(forward)
        grad_output = torch.empty_like(out)
        grads, bwd_launches = counted_capture(backward)
        # the static output alone: the captured autograd graph goes, and with
        # it the parameters' gradient accumulators it held on the side stream
        return Captured(fwd, bwd, static, out.detach(), grad_output, grads, fwd_launches,
                        bwd_launches)
