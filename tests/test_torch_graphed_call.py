"""The CUDA-graph replay of a module's call (``models/graphed_call.py``)
where the CPU can check it, for both of its callers, the editor's UNet
call (``VideoEditor._unet``, forward mode) and the trainer's
(``Trainer.unet_call``, backward mode): the key, the eager rule, the
cache shared by callers over one UNet, its bound, and a replay's
launch-count bookkeeping. Captures are stand-ins here (``Graphs.capture``
patched): the stand-in graphs' ``replay()`` run the model's own call into
the static buffers, with the counters set back, as a replay launches
nothing through Python. The replays on the card:
``tests/test_torch_gpu_graphs.py`` (the trainer) and
``tests/test_torch_gpu_graphed_unet.py`` (the editor)."""

import dataclasses
import functools
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.models import graphed_call as gc
from insv2v_torch.models import unet3d
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.graphed_call import Captured, Graphs, counted_capture, graphs_of
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import attention, fused_ff, norms
from insv2v_torch.parallel.dist import Group, frame_parallel
from insv2v_torch.text.tokenizer import HashTokenizer
from insv2v_torch.training.trainer import TrainConfig, Trainer
from insv2v_torch.utils import tracing

VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)
CALLERS = ("editor", "trainer")
PREFIX = {"editor": "sampler", "trainer": "train"}


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


def _stand_in_capture(self, fn, inputs, params, replay_span):
    """``Graphs.capture`` without CUDA: static inputs, one eager warm-up
    (and its backward), each capture's counted advance, and stand-in graphs
    that compute the call into the static output (and the backward into
    the static gradients) and launch nothing through Python."""
    static = [x.detach().clone() for x in inputs]
    live = {}

    def forward():  # under grad in backward mode, also inside ``_Replay.forward``
        with torch.set_grad_enabled(params is not None):
            live["out"] = fn(*static)
        return live["out"].detach()

    def backward():
        return torch.autograd.grad(live["out"], params, grad_output, allow_unused=True)

    forward()
    if params is not None:
        grad_output = torch.zeros_like(live["out"])
        backward()
    out, fwd_launches = counted_capture(forward)
    fwd = _StandIn(lambda: counted_capture(lambda: out.copy_(forward())))
    if params is None:
        return Captured(replay_span, fwd, static, out, fwd_launches)
    grads, bwd_launches = counted_capture(backward)
    bwd = _StandIn(lambda: counted_capture(
        lambda: [s.copy_(g) for s, g in zip(grads, backward()) if s is not None]))
    return Captured(replay_span, fwd, static, out, fwd_launches, bwd, grad_output, grads,
                    bwd_launches)


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
    monkeypatch.setattr(gc, "DEVICE_TYPES", ("cuda", "cpu"))
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


def _counts(prefix="sampler"):
    return tuple(tracing.count(f"{prefix}.{n}") for n in ("graph_capture", "graph_replay"))


def _editor(unet, steps, **kw):
    torch.manual_seed(1)
    return VideoEditor(unet, AutoencoderKL(VaeConfig(**VAE_KW)),
                       ClipTextEncoder(ClipTextConfig(**CLIP_KW)), tokenizer=TinyTokenizer(),
                       scheduler="ddim", num_steps=steps, device="cpu", dtype=torch.float32,
                       **kw)


def _trainer(unet, **cfg):
    return Trainer(unet, AutoencoderKL(VaeConfig(**VAE_KW)),
                   ClipTextEncoder(ClipTextConfig(**CLIP_KW)), TrainConfig(**cfg))


def _caller(caller, unet):
    """(the call, the model's own call, whether it records a gradient) of
    the editor's or the trainer's UNet call on ``_inputs()``."""
    sample, t, ctx = _inputs()
    if caller == "editor":
        editor = _editor(unet, 2)
        return (lambda: editor._unet(sample, t, ctx, 0),
                lambda: unet(sample, t, ctx, video_start_index=0), False)
    trainer = _trainer(unet)
    return (lambda: trainer.unet_call(sample, t, ctx),
            lambda: unet(sample, t, ctx, split_skip=False), True)


# --- the key -------------------------------------------------------------------

@pytest.mark.parametrize("caller", CALLERS)
def test_key_follows_what_the_call_observes(stand_in, monkeypatch, caller):
    """Every element of the key the caller's call makes: the inputs'
    shapes and dtypes, the autocast state, a parameter's storage and its
    ``requires_grad``, a submodule's train/eval flag, the UNet's ``cfg``,
    each dispatch switch, the mode and the caller's static part (the
    editor's window start and ``added_cond`` names): changing one gives
    another key, and setting it back gives the first again."""
    unet = _unet(remat=True)
    seen = []
    real_key = gc.call_key
    monkeypatch.setattr(gc, "call_key", lambda *a: seen.append(a) or real_key(*a))
    call, _, grad = _caller(caller, unet)
    with torch.set_grad_enabled(grad):
        call()
    ((_, _, inputs, static, backward),) = seen
    assert backward == grad and static == ((None, 0) if caller == "editor" else ())
    state = {"inputs": inputs, "static": static, "backward": backward}
    key = lambda: real_key(unet, list(unet.modules()), state["inputs"], state["static"],
                           state["backward"])
    first = key()
    sample, t, ctx = inputs

    def put(name, value):
        def change():
            old = state[name]
            state[name] = value
            return lambda: state.__setitem__(name, old)
        return change

    def autocast():
        ctx_manager = torch.autocast("cpu", dtype=torch.bfloat16)
        ctx_manager.__enter__()
        return lambda: ctx_manager.__exit__(None, None, None)

    def new_storage():
        p = unet.conv_in.weight
        old = p.data
        p.data = old.clone()
        return lambda: setattr(p, "data", old)

    def requires_grad():
        p = unet.conv_in.weight
        p.requires_grad_(not p.requires_grad)
        return lambda: p.requires_grad_(not p.requires_grad)

    def one_flag():
        child = next(iter(unet.children()))
        old = child.training
        child.train(not old)
        return lambda: child.train(old)

    def cfg_changed():
        old = unet.cfg
        unet.cfg = dataclasses.replace(old, remat=False)
        return lambda: setattr(unet, "cfg", old)

    def flip(module, name):
        def change():
            old = getattr(module, name)
            setattr(module, name, not old if isinstance(old, bool) else old + 1)
            return lambda: setattr(module, name, old)
        return change

    changes = [put("inputs", (torch.zeros((3, 4, 8, 8, 8)), t, ctx)),
               put("inputs", (sample, t, ctx.double())), autocast, new_storage, requires_grad,
               one_flag, cfg_changed, flip(attention, "FLASH_HEADFOLD"),
               flip(norms, "FUSED_LAYER_NORM"), flip(unet3d, "SPLIT_SKIP"),
               flip(unet3d, "SPLIT_SKIP_MAX_B"), put("backward", not backward)]
    if caller == "editor":
        changes += [put("static", (None, 2)), put("static", (("text_embeds", "time_ids"), 0))]
    for change in changes:
        undo = change()
        try:
            assert key() != first
        finally:
            undo()
        assert key() == first


# --- where the call runs eagerly ----------------------------------------------------

def _eager_outcome(unet, caller, grad=None) -> torch.Tensor:
    """The caller's call's output (with gradient recording as its mode
    has it, or ``grad``), after checking it captured and replayed
    nothing and equals the model's own call."""
    call, reference, mode = _caller(caller, unet)
    with torch.set_grad_enabled(mode if grad is None else grad):
        want = reference()
        got = call()
    assert _counts(PREFIX[caller]) == (0, 0)
    assert not graphs_of(unet).captured
    assert torch.equal(got, want)
    return got


def test_a_cpu_tensor_runs_the_model_call():
    _eager_outcome(_unet(), "editor")


@pytest.mark.parametrize("caller", CALLERS)
def test_grad_recording_runs_the_model_call(stand_in, caller):
    """Gradient recording that does not match the mode: on for the
    editor's forward-only call, off for the trainer's."""
    out = _eager_outcome(_unet(), caller, grad=caller == "editor")
    assert out.requires_grad == (caller == "editor")


@pytest.mark.parametrize("caller", CALLERS)
@pytest.mark.parametrize("hook", ["forward", "pre", "global"])
def test_a_module_hook_runs_the_model_call(stand_in, hook, caller):
    """A hook on a submodule deep in the UNet (as the SDXL benchmark cell
    hooks the added embedding), a pre-hook, or a global module hook: each
    call, the editor's or a training microbatch's, runs the model's Python,
    and the hook sees every call."""
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
        _eager_outcome(unet, caller)
        _eager_outcome(unet, caller)
    finally:
        handle.remove()
    assert len(seen) == 4  # two reference calls and two calls under test
    call, _, grad = _caller(caller, unet)
    with torch.set_grad_enabled(grad):
        call()
    assert _counts(PREFIX[caller]) == (1, 1)  # hook gone: the next call is captured


@pytest.mark.parametrize("caller", CALLERS)
def test_a_stack_with_its_own_span_runs_the_model_call(stand_in, caller):
    """A UNet whose transformers hold two blocks (``unet.stack.l<level>``
    spans) keeps them: every call runs eagerly and records its stacks."""
    unet = _unet(transformer_layers_per_block=2)
    with torch.no_grad():
        unet(*_inputs(), video_start_index=0)
    per_call = tracing.count("unet.stack.l0")
    assert per_call > 0
    _eager_outcome(unet, caller)
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
    with frame_parallel(one_rank_group):
        _eager_outcome(_unet(), "editor")
    assert one_rank_group.sent


# --- the graphed path, with stand-in graphs -------------------------------------------

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
    assert len(graphs_of(unet).captured) == starts
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


class _BackwardLaunch(torch.autograd.Function):
    """The identity, whose backward bumps a launch counter (as remat's
    reruns launch kernels in the backward)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        attention.temporal_attention.launches += 1
        return grad


class _CountingUNet(torch.nn.Module):
    """A stand-in model whose call bumps two launch counters, as the kernel
    wrappers do when the UNet launches its kernels, and whose backward one
    more."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, sample, t, ctx, video_start_index=0, added_cond=None, split_skip=None):
        attention.flash_attention.launches += 2
        fused_ff.fused_geglu_ff.launches += 1
        out = _BackwardLaunch.apply(sample[..., :4] * self.w) + ctx.mean() + video_start_index
        if added_cond is not None:
            out = out + added_cond["text_embeds"].sum()
        return out


def test_the_cache_keeps_the_newest_keys(stand_in):
    """``MAX_KEYS`` keys a UNet: the least recently replayed goes first,
    and calling it again captures it anew."""
    unet = _CountingUNet()
    editor = _editor(unet, 2)
    inputs = _inputs()
    call = lambda start: editor._unet(*inputs, start)
    n = gc.MAX_KEYS
    with torch.no_grad():
        for start in range(n):
            call(start)
        call(0)  # now the most recently replayed
        call(n)  # drops start 1
        assert _counts() == (n + 1, n + 2)
        starts = [key[1][1] for key in graphs_of(unet).captured]
        assert len(starts) == n and 1 not in starts and starts[-2:] == [0, n]
        call(0)
        assert _counts() == (n + 1, n + 3)
        call(1)
        assert _counts() == (n + 2, n + 4)
        assert len(graphs_of(unet).captured) == n


@pytest.mark.parametrize("mode", ["forward", "backward"])
def test_a_replay_counts_the_eager_calls_launches(stand_in, mode):
    """An eager call's advance of the counters (in backward mode its
    backward's too) is what each replayed call adds; the capturing call
    adds it twice (its eager warm-up, then its replay) and the capture
    itself nothing. The replayed call's output, and in backward mode the
    gradient that reaches the parameter through the autograd function,
    are the eager call's; in forward mode ``added_cond`` reaches the
    graphed call, and the replay returns the static output."""
    unet = _CountingUNet()
    sample, t, ctx = _inputs()
    backward = mode == "backward"
    if backward:
        trainer = _trainer(unet)
        graphed = lambda s: trainer.unet_call(s, t, ctx)
        eager = lambda s: unet(s, t, ctx, split_skip=False)
    else:
        added = {"time_ids": torch.ones((3, 6)), "text_embeds": torch.full((3, 4), 0.5)}
        editor = _editor(unet, 2)
        graphed = lambda s: editor._unet(s, t, ctx, 2, added)
        eager = lambda s: unet(s, t, ctx, video_start_index=2, added_cond=added)
    weight = torch.linspace(1.0, 2.0, 4)

    def step(fn, s):  # the call, and in backward mode its gradient to the parameter
        with torch.set_grad_enabled(backward):
            out = fn(s)
            grad = torch.autograd.grad((out * weight).sum(), [unet.w])[0] if backward else None
        return out, grad

    delta = lambda before: {k: v - before[k] for k, v in _counters().items() if v != before[k]}
    before = _counters()
    want = step(eager, sample)
    per_call = delta(before)
    assert per_call == {"flash_attention": 2, "fused_geglu_ff": 1,
                        **({"temporal_attention": 1} if backward else {})}
    before = _counters()
    # static buffers, which the next replay overwrites: cloned
    first = [x if x is None else x.clone() for x in step(graphed, sample)]
    assert delta(before) == {k: 2 * v for k, v in per_call.items()}
    for _ in range(2):
        before = _counters()
        out, grad = step(graphed, sample * 2)
        assert delta(before) == per_call
    assert torch.equal(first[0], want[0]) and (not backward or torch.equal(first[1], want[1]))
    want_out, want_grad = step(eager, sample * 2)
    assert torch.equal(out, want_out)
    (captured,) = graphs_of(unet).captured.values()
    assert captured.fwd.replays == 3
    if backward:
        assert torch.equal(grad, want_grad) and captured.bwd.replays == 3
    else:
        assert out is captured.output
    assert _counts(PREFIX["trainer" if backward else "editor"]) == (1, 3)


# --- the trainer ----------------------------------------------------------------

def _tiny_trainer(seed: int) -> Trainer:
    torch.manual_seed(seed)
    unet = UNet3DConditionModel(UNetConfig.tiny(remat=True))
    vae = AutoencoderKL(VaeConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1))
    text = ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=12, num_layers=1,
                                          num_heads=2, intermediate_size=24))
    return Trainer(unet, vae, text, TrainConfig(lr=1e-3, accumulate_grad_batches=2))


def test_cpu_trainer_never_captures():
    """On the CPU the UNet call is the model's own: no ``train.graph_*``
    span, nothing captured, and the step's numbers equal those of a
    trainer calling the model directly."""
    g = torch.Generator().manual_seed(0)
    batch = {"input_video": torch.rand((2, 2, 16, 16, 3), generator=g) * 2 - 1,
             "edited_video": torch.rand((2, 2, 16, 16, 3), generator=g) * 2 - 1,
             "prompt_ids": torch.randint(0, 64, (2, 77), generator=g)}
    graphed, direct = _tiny_trainer(1), _tiny_trainer(1)
    direct.unet_call = functools.partial(direct.unet, split_skip=False)
    out = []
    for trainer in (graphed, direct):
        state = trainer.create_state()
        _, m = trainer.train_step(state, batch, torch.Generator().manual_seed(2))
        out.append((m["train_loss"], [p.clone() for p in state.params.values()]))
    assert tracing.count("train.graph_capture") == 0
    assert tracing.count("train.graph_replay") == 0
    assert tracing.count("train.forward") == 4
    assert not graphs_of(graphed.unet).captured
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_pe_tables_follow_the_loaded_weights():
    """Each motion module's PE table (not in the state dict) is made on the
    ambient device, and a state-dict load makes it anew on the device of
    the weights it was handed: a UNet built on the meta device and handed
    host weights with ``assign=True`` gets the same tables as one built
    on the host."""
    host = UNet3DConditionModel(UNetConfig.tiny())
    with torch.device("meta"):
        meta = UNet3DConditionModel(UNetConfig.tiny())
    pe = lambda m: [b for name, b in m.named_buffers() if name.endswith(".pe")]
    assert pe(host) and all(t.is_meta for t in pe(meta))
    meta.load_state_dict(host.state_dict(), assign=True)
    assert all(a.device.type == "cpu" and torch.equal(a, b) for a, b in zip(pe(meta), pe(host)))
