"""The editor's CUDA-graph path (``diffusion/graphed_unet.py``) where the
CPU can check it: the key, the eager fallbacks, the cache shared by
editors over one UNet, its bound, and a replay's launch-count bookkeeping.
Captures are stand-ins here (``Graphs.capture`` patched): the stand-in
graph's ``replay()`` runs the model's own call into the static output,
with the counters set back, as a replay launches nothing through Python.
The replays on the card: ``tests/test_torch_gpu_graphed_unet.py``."""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from insv2v_torch.diffusion import graphed_unet
from insv2v_torch.diffusion.graphed_unet import Graphs, Replay, graphs_of, unet_call
from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.models import unet3d
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import attention, fused_ff, norms
from insv2v_torch.parallel.dist import Group, frame_parallel
from insv2v_torch.text.tokenizer import HashTokenizer
from insv2v_torch.training.cuda_graphs import counted_capture
from insv2v_torch.utils import tracing

VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)


class TinyTokenizer(HashTokenizer):
    vocab_size = 100
    sot_id = 98
    eot_id = 99


class _StandIn:
    """A graph's stand-in: ``replay()`` runs the given function."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


def _stand_in_capture(self, fn, inputs):
    """``Graphs.capture`` without CUDA: static inputs, one eager warm-up,
    the capture's counted advance, and a stand-in graph that computes the
    call into the static output and launches nothing through Python."""
    static = [x.detach().clone() for x in inputs]
    fn(*static)
    out, launches = counted_capture(lambda: fn(*static))
    graph = _StandIn(lambda: counted_capture(lambda: out.copy_(fn(*static))))
    return Replay(graph, static, out, launches)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def stand_in(monkeypatch):
    """CPU calls take the graphed path, captured by the stand-in."""
    monkeypatch.setattr(graphed_unet, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(Graphs, "capture", _stand_in_capture)


def _unet(seed=0, **kw):
    torch.manual_seed(seed)
    return UNet3DConditionModel(UNetConfig.tiny(**kw)).eval()


def _inputs(frames=2, batch=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, frames, 8, 8, 8), generator=g),
            torch.full((batch,), 501, dtype=torch.int64),
            torch.randn((batch, 77, 12), generator=g))


def _counters():
    return {f.__name__: f.launches for f in tracing.kernel_wrappers()}


def _counts():
    return tuple(tracing.count(n) for n in ("sampler.graph_capture", "sampler.graph_replay"))


# --- the key -------------------------------------------------------------------

def test_key_follows_what_the_call_observes():
    """Shapes, the window start, the ``added_cond`` names, a parameter's
    storage, a submodule's train/eval flag, the UNet's ``cfg`` and each
    dispatch switch are part of a graph's key: changing one gives another
    key, and setting it back gives the first again."""
    unet = _unet()
    sample, t, ctx = _inputs()
    added = {"text_embeds": torch.zeros((3, 4)), "time_ids": torch.zeros((3, 6))}
    state = {"inputs": (sample, t, ctx), "names": None, "start": 0}
    key = lambda: graphed_unet._key(unet, state["inputs"], state["names"], state["start"],
                                    graphed_unet._flags(unet))
    first = key()

    def put(name, value):
        def change():
            old = state[name]
            state[name] = value
            return lambda: state.__setitem__(name, old)
        return change

    def new_storage():
        p = unet.conv_in.weight
        old = p.data
        p.data = old.clone()
        return lambda: setattr(p, "data", old)

    def one_train():
        next(iter(unet.children())).train()
        return lambda: unet.eval()

    def cfg_changed():
        old = unet.cfg
        unet.cfg = dataclasses.replace(old, split_skip=False)
        return lambda: setattr(unet, "cfg", old)

    def flip(module, name):
        def change():
            old = getattr(module, name)
            setattr(module, name, not old if isinstance(old, bool) else old + 1)
            return lambda: setattr(module, name, old)
        return change

    more_frames = (torch.zeros((3, 4, 8, 8, 8)), t, ctx)
    with_added = (sample, t, ctx, added["text_embeds"], added["time_ids"])
    changes = (put("inputs", more_frames), put("start", 2), new_storage, one_train, cfg_changed,
               flip(attention, "FLASH_HEADFOLD"), flip(norms, "FUSED_LAYER_NORM"),
               flip(unet3d, "SPLIT_SKIP"), flip(unet3d, "SPLIT_SKIP_MAX_B"))
    for change in changes:
        undo = change()
        try:
            assert key() != first
        finally:
            undo()
        assert key() == first
    state.update(inputs=with_added, names=("text_embeds", "time_ids"))
    with_names = key()
    state["names"] = ("text_embeds", "time_ids2")
    assert key() != with_names != first


# --- where the call runs eagerly ----------------------------------------------------

def _eager_outcome(unet, call) -> torch.Tensor:
    """``call()``'s output, after checking it captured and replayed nothing."""
    with torch.no_grad():
        want = unet(*_inputs()[:3], video_start_index=0)
    got = call()
    assert _counts() == (0, 0)
    assert not graphs_of(unet).replays
    assert torch.equal(got, want)
    return got


def test_a_cpu_tensor_runs_the_model_call():
    unet = _unet()
    with torch.no_grad():
        _eager_outcome(unet, lambda: unet_call(unet, *_inputs(), 0))


def test_grad_recording_runs_the_model_call(stand_in):
    unet = _unet()
    with torch.enable_grad():
        out = _eager_outcome(unet, lambda: unet_call(unet, *_inputs(), 0))
    assert out.requires_grad


@pytest.mark.parametrize("hook", ["forward", "pre", "global"])
def test_a_module_hook_runs_the_model_call(stand_in, hook):
    """A hook on a submodule deep in the UNet (as the SDXL driver hooks the
    added embedding), a pre-hook, or a global module hook: each call runs
    the model's Python, and the hook sees every call."""
    unet = _unet()
    seen = []
    target = unet.up_blocks[1].resnets[0]
    if hook == "forward":
        handle = target.register_forward_hook(lambda m, a, out: seen.append(out.shape))
    elif hook == "pre":
        handle = target.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape))
    else:
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda m, a, out: seen.append(m) if m is target else None)
    try:
        with torch.no_grad():
            _eager_outcome(unet, lambda: unet_call(unet, *_inputs(), 0))
    finally:
        handle.remove()
    assert len(seen) == 2  # the reference call and the call under test
    with torch.no_grad():
        unet_call(unet, *_inputs(), 0)
    assert _counts() == (1, 1)  # hook gone: the next call is captured


def test_a_stack_with_its_own_span_runs_the_model_call(stand_in):
    """A UNet whose transformers hold two blocks (``unet.stack.l<level>``
    spans) keeps them: every call runs eagerly and records its stacks."""
    unet = _unet(transformer_layers_per_block=2)
    with torch.no_grad():
        unet(*_inputs(), video_start_index=0)
    per_call = tracing.count("unet.stack.l0")
    assert per_call > 0
    with torch.no_grad():
        _eager_outcome(unet, lambda: unet_call(unet, *_inputs(), 0))
    assert tracing.count("unet.stack.l0") == 3 * per_call


@pytest.fixture
def one_rank_group():
    """A one-process gloo group on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield Group()
    finally:
        dist.destroy_process_group()


def test_frame_parallel_runs_the_model_call(stand_in, one_rank_group):
    """Inside ``frame_parallel`` the motion modules exchange frames over
    the group: the call runs eagerly, and the group carries its moments."""
    unet = _unet()
    with torch.no_grad(), frame_parallel(one_rank_group):
        _eager_outcome(unet, lambda: unet_call(unet, *_inputs(), 0))
    assert one_rank_group.sent


# --- the graphed path, with stand-in graphs -------------------------------------------

def _editor(unet, steps, **kw):
    torch.manual_seed(1)
    return VideoEditor(unet, AutoencoderKL(VaeConfig(**VAE_KW)),
                       ClipTextEncoder(ClipTextConfig(**CLIP_KW)), tokenizer=TinyTokenizer(),
                       scheduler="ddim", num_steps=steps, device="cpu", dtype=torch.float32,
                       **kw)


EDIT_KW = dict(frames_per_window=4, num_ref_frames=1, seed=3)


def _frames(n=9):
    return np.clip(np.random.RandomState(0).randn(n, 16, 16, 3) * 0.3, -1, 1).astype(np.float32)


def test_two_editors_share_the_unets_graphs(stand_in):
    """A warm-up editor over the UNet captures one graph a window start;
    a second editor over the same UNet, with another number of steps,
    captures nothing and replays every call; its edit equals the same
    edit called eagerly."""
    unet = _unet()
    warm = _editor(unet, 2)
    warm(_frames(), "make it snowy", **EDIT_KW)
    starts = 3  # 9 frames in windows of 4 with 1 ref: starts 0, 3, 5
    assert _counts() == (starts, 2 * starts)
    assert len(graphs_of(unet).replays) == starts
    editor = _editor(unet, 3)
    got = editor(_frames(), "make it snowy", **EDIT_KW)
    assert _counts() == (starts, 5 * starts)
    assert tracing.count("sampler.unet") == 5 * starts

    eager = _editor(_unet(), 3)  # same seeds and weights, no graphs
    handle = eager.unet.register_forward_pre_hook(lambda m, a: None)
    try:
        want = eager(_frames(), "make it snowy", **EDIT_KW)
    finally:
        handle.remove()
    assert _counts() == (starts, 5 * starts)
    np.testing.assert_array_equal(got, want)


class _CountingUNet(torch.nn.Module):
    """A stand-in model whose call bumps two launch counters, as the kernel
    wrappers do when the UNet launches its kernels."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, sample, t, ctx, video_start_index=0, added_cond=None):
        attention.flash_attention.launches += 2
        fused_ff.fused_geglu_ff.launches += 1
        out = sample[..., :4] * self.w + ctx.mean() + video_start_index
        if added_cond is not None:
            out = out + added_cond["text_embeds"].sum()
        return out


def test_the_cache_keeps_the_newest_keys(stand_in):
    """``MAX_KEYS`` keys a UNet: the least recently replayed goes first,
    and calling it again captures it anew."""
    unet = _CountingUNet()
    inputs = _inputs()
    call = lambda start: unet_call(unet, *inputs, start)
    n = graphed_unet.MAX_KEYS
    with torch.no_grad():
        for start in range(n):
            call(start)
        call(0)  # now the most recently replayed
        call(n)  # drops start 1
        assert _counts() == (n + 1, n + 2)
        starts = [key[2] for key in graphs_of(unet).replays]
        assert len(starts) == n and 1 not in starts and starts[-2:] == [0, n]
        call(0)
        assert _counts() == (n + 1, n + 3)
        call(1)
        assert _counts() == (n + 2, n + 4)
        assert len(graphs_of(unet).replays) == n


def test_a_replay_counts_the_eager_calls_launches(stand_in):
    """An eager call's advance of the counters is what each replayed call
    adds; the capturing call adds it twice (its eager warm-up, then its
    replay) and the capture itself nothing. ``added_cond`` reaches the
    graphed call, and the replay returns the static output."""
    unet = _CountingUNet()
    sample, t, ctx = _inputs()
    added = {"time_ids": torch.ones((3, 6)), "text_embeds": torch.full((3, 4), 0.5)}
    delta = lambda before: {k: v - before[k] for k, v in _counters().items() if v != before[k]}
    with torch.no_grad():
        before = _counters()
        want = unet(sample, t, ctx, video_start_index=2, added_cond=added)
        eager = delta(before)
        assert eager == {"flash_attention": 2, "fused_geglu_ff": 1}
        before = _counters()
        first = unet_call(unet, sample, t, ctx, 2, added).clone()
        assert delta(before) == {k: 2 * v for k, v in eager.items()}
        for _ in range(2):
            before = _counters()
            out = unet_call(unet, sample * 2, t, ctx, 2, added)
            assert delta(before) == eager
    assert torch.equal(first, want)
    assert torch.equal(out, unet(sample * 2, t, ctx, video_start_index=2, added_cond=added))
    (replay,) = graphs_of(unet).replays.values()
    assert out is replay.output and replay.graph.replays == 3
    assert _counts() == (1, 3)
