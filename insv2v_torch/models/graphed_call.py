"""A module's call replayed from captured CUDA graphs.

A call that comes again and again with the same shapes (the editor's 3-way
UNet call of a window, the trainer's microbatch) is captured once a key on
a CUDA device and replayed for every later call: the host launches one
graph where it dispatched the module op by op. ``graphed_call`` has two
modes, which its caller declares:

  * forward (``VideoEditor._unet``): the call records no gradient, and a
    replay returns the key's static output;
  * backward (``Trainer.unet_call``): the call records a gradient to the
    module's parameters that require grad; the backward to them is
    captured too, and an autograd ``Function`` (``_Replay``, the rule of
    ``torch.cuda.make_graphed_callables``) replays it.

The key (``call_key``) is what the call can observe: the inputs' shapes
and dtypes, the device, the autocast state, every parameter's and
buffer's storage and ``requires_grad``, every submodule's train/eval flag,
the module's ``cfg`` (the UNet's remat and split skip among it), the
kernels' dispatch switches (``attention.FLASH_HEADFOLD``,
``norms.FUSED_LAYER_NORM``, ``unet3d.SPLIT_SKIP``,
``unet3d.SPLIT_SKIP_MAX_B``), the mode, and a static part that the caller
passes for what its ``fn`` fixes in Python (the editor's ``added_cond``
names and window start, with which the motion modules slice their PE
tables on the host). A new key captures anew, and a reallocated parameter
is never read through an old graph. A graph reads device memory only: a
buffer left on the host fails the capture.

Where the call runs eagerly, as ``fn`` itself (``runs_eagerly``). A replay
runs no Python, so the call is ``fn``'s wherever Python has to run: on a
tensor off the CUDA device; with an input that requires grad; with
gradient recording that does not match the mode (on in forward mode, off
in backward mode); inside ``frame_parallel`` (the motion modules'
all-to-alls); where any submodule carries a forward hook or pre-hook, or a
global module hook exists (checked on every call, as a hook can come at
any time); and where a submodule opens a span of its own
(``Transformer3DModel.span_name``: the stacks of more than one block),
whose records a replay would drop.

Capture (``Graphs.capture``): static copies of the inputs; one eager
warm-up on the module's side stream, which initialises what is lazy
(kernel libraries, cuBLAS workspaces); the forward captured on that stream
in ``thread_local`` mode, so that another thread (the prefetch loader
pinning host memory) may call into CUDA meanwhile. The forward's warm-up
and capture run under the ambient autocast with its weight cache off (a
cast cached outside the graph would be read stale inside it). In backward
mode the warm-up runs the backward too, and the backward is captured after
the forward from a static incoming gradient, both without autocast, where
the trainer runs its backward (autograd carries its caller's autocast
state into a backward).

Where the graphs live: with the module (a ``WeakKeyDictionary``), not with
the caller, so two callers over one module share them (a warm-up edit
captures what a later edit replays). A module keeps its newest
``MAX_KEYS`` keys, one private memory pool and one side stream. Its keys
share the pool as its calls never overlap (one module is not called from
two threads at once; the web demo serialises its edits) and each key's
static buffers stay referenced.

Static buffers. The output a call returns, and in backward mode the
gradients its backward hands on, are the key's static buffers, which the
next replay of the key overwrites: consume the output before the next
call, and run a call's backward, and consume its gradients, before the
next call.

Launch counters. The kernel wrappers count their launches in Python
(``.launches``), which a replay does not pass through. A capture records
each counter's advance and sets the counters back (``counted_capture``),
as a capture launches nothing; every replay adds that advance
(``add_launches``). A replayed call therefore leaves the counters as the
eager call does; the warm-up, which does launch, counts as an eager call.

Spans: ``<prefix>.graph_capture`` for each capture and
``<prefix>.graph_replay`` for each forward replay (a capturing call
replays too), the prefix the caller's (``sampler``, ``train``).
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

import torch

from insv2v_torch.models import unet3d
from insv2v_torch.ops import attention, norms
from insv2v_torch.parallel.dist import frame_group
from insv2v_torch.utils.tracing import kernel_wrappers, span

__all__ = ["graphed_call", "graphs_of", "MAX_KEYS"]

MAX_KEYS = 8  # keys kept a module, the least recently replayed dropped first
DEVICE_TYPES = ("cuda",)  # where a call is captured

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
    """One key's forward graph and, in backward mode, its backward graph
    (anything with ``replay()``), the static buffers they read and write,
    and each graph's advance of the launch counters."""

    def __init__(self, replay_span: str, fwd, inputs: Sequence[torch.Tensor],
                 output: torch.Tensor, fwd_launches: Dict[str, int], bwd=None,
                 grad_output: Optional[torch.Tensor] = None,
                 grads: Sequence[Optional[torch.Tensor]] = (),
                 bwd_launches: Optional[Dict[str, int]] = None):
        self.replay_span, self.fwd, self.bwd = replay_span, fwd, bwd
        self.inputs, self.output, self.grad_output = list(inputs), output, grad_output
        self.grads = tuple(grads)
        self.fwd_launches, self.bwd_launches = fwd_launches, bwd_launches

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        with span(self.replay_span):
            self.fwd.replay()
        add_launches(self.fwd_launches)
        return self.output

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
        ctx.captured, ctx.n_inputs = captured, len(captured.inputs)
        return captured.forward(tensors[:ctx.n_inputs]).detach()

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


class Graphs:
    """One module's captured keys, least recently replayed first, the
    memory pool they share and the side stream they are captured on."""

    def __init__(self):
        self.captured: "collections.OrderedDict[tuple, Captured]" = collections.OrderedDict()
        self.pool = self.stream = None

    def get(self, key: tuple, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
            params: Optional[List[torch.Tensor]], span_prefix: str) -> Captured:
        """The key's graphs, captured now where the key is new."""
        captured = self.captured.get(key)
        if captured is None:
            while len(self.captured) >= MAX_KEYS:
                self.captured.popitem(last=False)
            with span(f"{span_prefix}.graph_capture"):
                captured = self.captured[key] = self.capture(fn, inputs, params,
                                                             f"{span_prefix}.graph_replay")
        else:
            self.captured.move_to_end(key)
        return captured

    def capture(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                params: Optional[List[torch.Tensor]], replay_span: str) -> Captured:
        """Capture ``fn`` on ``inputs``, and its backward to ``params``
        unless they are None (the module docstring)."""
        dev = inputs[0].device
        if self.stream is None:
            self.stream, self.pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        side, ambient = self.stream, torch.cuda.current_stream(dev)
        static = [x.detach().clone() for x in inputs]
        graph = lambda g: torch.cuda.graph(g, pool=self.pool, stream=side,
                                           capture_error_mode="thread_local")
        no_autocast = lambda: torch.autocast(dev.type, enabled=False)
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            with _uncached_autocast(dev.type):
                out = fn(*static)
            if params is not None:
                with no_autocast():
                    torch.autograd.grad(out, params, torch.zeros_like(out), allow_unused=True)
            del out
        ambient.wait_stream(side)
        fwd = torch.cuda.CUDAGraph()

        def forward():
            with _uncached_autocast(dev.type), graph(fwd):
                return fn(*static)

        out, fwd_launches = counted_capture(forward)
        if params is None:
            return Captured(replay_span, fwd, static, out, fwd_launches)
        bwd, grad_output = torch.cuda.CUDAGraph(), torch.empty_like(out)

        def backward():
            with no_autocast(), graph(bwd):
                return torch.autograd.grad(out, params, grad_output, allow_unused=True)

        grads, bwd_launches = counted_capture(backward)
        # the static output alone: the captured autograd graph goes, and with
        # it the parameters' gradient accumulators it held on the side stream
        return Captured(replay_span, fwd, static, out.detach(), fwd_launches, bwd, grad_output,
                        grads, bwd_launches)


_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, Graphs]" = weakref.WeakKeyDictionary()


def graphs_of(module: torch.nn.Module) -> Graphs:
    """``module``'s graphs, made empty on first use."""
    graphs = _GRAPHS.get(module)
    if graphs is None:
        graphs = _GRAPHS[module] = Graphs()
    return graphs


def runs_eagerly(modules: Sequence[torch.nn.Module], inputs: Sequence[torch.Tensor],
                 backward: bool) -> bool:
    """Whether the call of the module whose submodules are ``modules`` has
    to run as ``fn`` itself (the module docstring)."""
    nn_module = torch.nn.modules.module
    return (inputs[0].device.type not in DEVICE_TYPES
            or torch.is_grad_enabled() != backward
            or any(x.requires_grad for x in inputs)
            or frame_group() is not None
            or bool(nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks)
            or any(m._forward_hooks or m._forward_pre_hooks or vars(m).get("span_name")
                   for m in modules))


def call_key(module: torch.nn.Module, modules: Sequence[torch.nn.Module],
             inputs: Sequence[torch.Tensor], static: tuple, backward: bool) -> tuple:
    """What the call can observe (the module docstring): its graphs' key.
    ``modules``: ``module.modules()``, walked once a call; the parameters
    and buffers are read from it."""
    dev = inputs[0].device
    state = tuple((t.data_ptr(), t.requires_grad) for m in modules
                  for t in (*m._parameters.values(), *m._buffers.values()) if t is not None)
    return (tuple((x.shape, x.dtype) for x in inputs), static, backward, dev,
            torch.is_autocast_enabled(dev.type), torch.get_autocast_dtype(dev.type), state,
            tuple(m.training for m in modules), getattr(module, "cfg", None),
            attention.FLASH_HEADFOLD, norms.FUSED_LAYER_NORM, unet3d.SPLIT_SKIP,
            unet3d.SPLIT_SKIP_MAX_B)


def graphed_call(module: torch.nn.Module, fn: Callable[..., torch.Tensor], *inputs: torch.Tensor,
                 span_prefix: str, static: tuple = (), backward: bool = False) -> torch.Tensor:
    """``fn(*inputs)``, a call of ``module``, replayed on a CUDA device from
    graphs captured once a key (the module docstring). With ``backward``
    the call is differentiable in ``module``'s parameters that require
    grad, else it records no gradient. A replayed call returns the key's
    static output: consume it before the next call."""
    modules = list(module.modules())
    if runs_eagerly(modules, inputs, backward):
        return fn(*inputs)
    params = [p for p in module.parameters() if p.requires_grad] if backward else None
    graphs = graphs_of(module)
    captured = graphs.get(call_key(module, modules, inputs, static, backward), fn, inputs,
                          params, span_prefix)
    if params is None:
        return captured.forward(inputs)
    return _Replay.apply(captured, *inputs, *params)
