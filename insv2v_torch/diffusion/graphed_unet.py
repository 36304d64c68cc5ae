"""The editor's UNet call replayed from captured CUDA graphs.

Inside an edit, every 3-way UNet call of a window has the same shapes, so
on a CUDA device ``unet_call`` captures the UNet's forward once for each
key and replays it for every later call: the host launches one graph a
step where it dispatched the forward op by op. It is the forward half of
the trainer's ``training/cuda_graphs.py::GraphedCall``:

  * a replay copies the call's tensors (the sample, the timesteps, the
    context and each ``added_cond`` tensor, in the order of their sorted
    names) into static inputs and replays the graph on the current stream;
  * before the capture, one eager call on a side stream warms up what
    initialises lazily (kernel libraries, cuBLAS workspaces); the capture
    runs on that stream in ``thread_local`` mode, under the ambient
    autocast with its weight cache off (a cast cached outside the graph
    would be read stale inside it);
  * no backward graph and no autograd function: the call records no
    gradient.

The key is what the call can observe: the inputs' shapes and dtypes (and
so which ``added_cond`` names are present), ``video_start_index`` (the
motion modules slice their PE tables with it on the host), the device, the
autocast state, every parameter's and buffer's storage, every submodule's
train/eval flag, the UNet's ``cfg`` and the dispatch switches
(``attention.FLASH_HEADFOLD``, ``norms.FUSED_LAYER_NORM``, the split-skip
rule's ``unet3d.SPLIT_SKIP`` and ``SPLIT_SKIP_MAX_B``). A new key captures
anew; a reallocated parameter is never read through an old graph.

Where the graphs live. They belong to the UNet module (a
``WeakKeyDictionary``), not to its caller, so two editors over one UNet
share them: a warm-up edit captures what a later edit replays. All of one
UNet's keys share one private memory pool, as their calls never overlap
and each key's static output stays referenced; the newest ``MAX_KEYS``
keys are kept, so videos of many lengths do not grow the cache without
end. Calls never overlap because one UNet is not called from two threads
at once (the web demo serialises its edits): a key's static buffers serve
one call at a time.

Where the call runs eagerly, exactly as the model's own call. A replay runs
no Python, so the call is the model's own where Python has to run: on a
CPU tensor; with gradient recording on; inside ``frame_parallel`` (the
motion modules' all-to-alls); where any module of the UNet carries a
forward hook or pre-hook, or a global module hook exists (checked on every
call, as a hook can come at any time); and where any submodule opens a
span of its own (``Transformer3DModel.span_name``: the stacks of more than
one block), whose records a replay would drop.

Static output. The tensor a replayed call returns is the key's static
output, which the next replay of the key overwrites: consume it before the
next call (``dual_cfg_eps`` takes ``.float().chunk(3)`` of it at once), or
clone what you keep.

Launch counters. The kernel wrappers count their launches in Python
(``.launches``), which a replay does not pass through. A capture records
each counter's advance and sets the counters back
(``training.cuda_graphs.counted_capture``); every replay adds that advance
(``add_launches``). A replayed call therefore leaves the counters as the
eager call does; the warm-up, which does launch, counts as an eager call.

Spans: ``sampler.graph_capture`` for each capture and
``sampler.graph_replay`` for each replay (a capturing call replays too).
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from insv2v_torch.models import unet3d
from insv2v_torch.ops import attention, norms
from insv2v_torch.parallel.dist import frame_group
from insv2v_torch.training.cuda_graphs import _uncached_autocast, add_launches, counted_capture
from insv2v_torch.utils.tracing import span

__all__ = ["unet_call", "graphs_of", "MAX_KEYS"]

MAX_KEYS = 8  # keys kept a UNet, the least recently replayed dropped first
DEVICE_TYPES = ("cuda",)  # where a call is captured


class Replay:
    """One key's captured forward: the graph (anything with ``replay()``),
    the static inputs and output it reads and writes, and the capture's
    advance of the launch counters."""

    def __init__(self, graph, inputs: Sequence[torch.Tensor], output: torch.Tensor,
                 launches: Dict[str, int]):
        self.graph, self.inputs, self.output, self.launches = graph, list(inputs), output, launches

    def __call__(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        with span("sampler.graph_replay"):
            self.graph.replay()
        add_launches(self.launches)
        return self.output


class Graphs:
    """One UNet's captured keys, least recently replayed first, the memory
    pool they share and the side stream they are captured on."""

    def __init__(self):
        self.replays: "collections.OrderedDict[tuple, Replay]" = collections.OrderedDict()
        self.pool = self.stream = None

    def __call__(self, key: tuple, fn: Callable[..., torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        replay = self.replays.get(key)
        if replay is None:
            while len(self.replays) >= MAX_KEYS:
                self.replays.popitem(last=False)
            with span("sampler.graph_capture"):
                replay = self.replays[key] = self.capture(fn, inputs)
        else:
            self.replays.move_to_end(key)
        return replay(inputs)

    def capture(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor]) -> Replay:
        dev = inputs[0].device
        if self.stream is None:
            self.stream, self.pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        side, ambient = self.stream, torch.cuda.current_stream(dev)
        static = [x.detach().clone() for x in inputs]
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(ambient)
        with torch.cuda.stream(side), _uncached_autocast(dev.type):
            fn(*static)
        ambient.wait_stream(side)

        def forward():
            with _uncached_autocast(dev.type), torch.cuda.graph(
                    graph, pool=self.pool, stream=side, capture_error_mode="thread_local"):
                return fn(*static)

        out, launches = counted_capture(forward)
        return Replay(graph, static, out, launches)


_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, Graphs]" = weakref.WeakKeyDictionary()


def graphs_of(unet: torch.nn.Module) -> Graphs:
    """``unet``'s graphs, made empty on first use."""
    graphs = _GRAPHS.get(unet)
    if graphs is None:
        graphs = _GRAPHS[unet] = Graphs()
    return graphs


def _flags(unet: torch.nn.Module) -> Optional[tuple]:
    """Every submodule's train/eval flag, or None where the call has to run
    eagerly: a module hook, or a submodule that opens its own span."""
    nn_module = torch.nn.modules.module
    if nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks:
        return None
    flags = []
    for m in unet.modules():
        if m._forward_hooks or m._forward_pre_hooks or vars(m).get("span_name"):
            return None
        flags.append(m.training)
    return tuple(flags)


def _key(unet: torch.nn.Module, inputs: Sequence[torch.Tensor], names: tuple,
         video_start_index: int, flags: tuple) -> tuple:
    dev = inputs[0].device
    return (tuple((x.shape, x.dtype) for x in inputs), names, video_start_index, dev,
            torch.is_autocast_enabled(dev.type), torch.get_autocast_dtype(dev.type),
            tuple(t.data_ptr() for t in (*unet.parameters(), *unet.buffers())), flags,
            getattr(unet, "cfg", None), attention.FLASH_HEADFOLD, norms.FUSED_LAYER_NORM,
            unet3d.SPLIT_SKIP, unet3d.SPLIT_SKIP_MAX_B)


def unet_call(unet: torch.nn.Module, sample: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
              video_start_index: int,
              added_cond: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """``unet(sample, t, ctx, video_start_index=..., added_cond=...)``,
    replayed from a graph captured once a key where nothing needs the
    module's Python (the module docstring). A replayed call returns the
    key's static output: consume it before the next call."""
    flags = None
    if (sample.device.type in DEVICE_TYPES and not torch.is_grad_enabled()
            and frame_group() is None):
        flags = _flags(unet)
    if flags is None:
        return unet(sample, t, ctx, video_start_index=video_start_index, added_cond=added_cond)
    names = tuple(sorted(added_cond)) if added_cond is not None else None
    inputs = (sample, t, ctx) + tuple(added_cond[k] for k in names or ())

    def fn(*xs):
        added = None if names is None else dict(zip(names, xs[3:]))
        return unet(xs[0], xs[1], xs[2], video_start_index=video_start_index, added_cond=added)

    key = _key(unet, inputs, names, video_start_index, flags)
    return graphs_of(unet)(key, fn, inputs)
