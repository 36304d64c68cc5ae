"""The editor's CUDA-graph replay (``models/graphed_call.py``, forward
mode) against its eager call on the card (marker ``gpu``; they skip on a
machine without one). This file imports torch and the port only, so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu_graphed_unet.py -m gpu --noconftest

The smallest UNet3D the kernels take (widths 320 and 640, one layer a
level, so that A, B and C launch; ``UNetConfig.tiny``'s width 8 is not one
of kernel B's), a VAE whose mid-block attention runs kernel A, and a
one-layer CLIP text encoder, in bf16. The eager side is the same editor
with a no-op forward pre-hook on its UNet, which the rule sends down the
model's own call."""

import contextlib

import numpy as np
import pytest
import torch

from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.graphed_call import graphs_of
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.text.tokenizer import HashTokenizer
from insv2v_torch.utils import tracing

pytestmark = pytest.mark.gpu

UNET = UNetConfig(block_out_channels=(320, 640),
                  down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                  up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"), layers_per_block=1,
                  cross_attention_dim=64, motion_module_resolutions=(1, 2))
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
CLIP_KW = dict(vocab_size=100, hidden_size=64, num_layers=1, num_heads=2, intermediate_size=128)
# 32 frames in windows of 16 with 4 refs: window starts 0, 12 and 16
EDIT_KW = dict(frames_per_window=16, num_ref_frames=4, seed=3)


class TinyTokenizer(HashTokenizer):
    vocab_size = 100
    sot_id = 98
    eot_id = 99


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph is captured on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.clear()
    yield
    tracing.clear()


def _unet() -> UNet3DConditionModel:
    """The UNet with every tensor drawn from one seed: no zero-initialised
    projection, so the motion modules (and their PE tables) reach the
    output."""
    gen = torch.Generator().manual_seed(0)
    unet = UNet3DConditionModel(UNET)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.copy_((name.endswith("weight")) + 0.1 * torch.randn(p.shape, generator=gen))
    return unet


def _editor(cuda, steps: int) -> VideoEditor:
    torch.manual_seed(0)
    return VideoEditor(_unet(), AutoencoderKL(VaeConfig(**VAE_KW)),
                       ClipTextEncoder(ClipTextConfig(**CLIP_KW)), tokenizer=TinyTokenizer(),
                       scheduler="ddim", num_steps=steps, device=cuda)


@contextlib.contextmanager
def _eager(editor):
    handle = editor.unet.register_forward_pre_hook(lambda m, a: None)
    try:
        yield
    finally:
        handle.remove()


def _frames(n=32, size=32):
    rs = np.random.RandomState(0)
    return np.clip(rs.randn(n, size, size, 3) * 0.3, -1, 1).astype(np.float32)


def _counts():
    return tuple(tracing.count(n) for n in ("sampler.graph_capture", "sampler.graph_replay",
                                            "sampler.unet"))


def test_graphed_edit_equals_the_eager_edit(cuda):
    """A 50-step DDIM edit of 32 frames in three windows with refs, in
    bf16: captured at the three window starts and
    replayed for every call, it returns the eager edit's frames bit for
    bit (the graph launches the eager call's kernels on the same inputs)."""
    editor = _editor(cuda, 50)
    with _eager(editor):
        want = editor(_frames(), "make it snowy", **EDIT_KW)
    assert _counts() == (0, 0, 150)
    got = editor(_frames(), "make it snowy", **EDIT_KW)
    assert _counts() == (3, 150, 300)
    assert len(graphs_of(editor.unet).captured) == 3
    np.testing.assert_array_equal(got, want)


def test_a_new_window_start_captures_anew(cuda):
    """The PE tables are sliced by the window start on the host: the same
    shapes at another start are another graph, and its output is the
    eager call's at that start."""
    editor = _editor(cuda, 2)
    unet = editor.unet
    g = torch.Generator(device=cuda).manual_seed(1)
    sample = torch.randn((3, 16, 16, 16, 8), generator=g, device=cuda)
    t = torch.full((3,), 501, dtype=torch.int64, device=cuda)
    ctx = torch.randn((3, 77, 64), generator=g, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        outs = {}
        for start in (0, 0, 12):
            outs[start] = editor._unet(sample, t, ctx, start).clone()
        assert _counts()[:2] == (2, 3)
        for start, out in outs.items():
            want = unet(sample, t, ctx, video_start_index=start)
            assert torch.equal(out, want), start
    assert not torch.equal(outs[0], outs[12])


def test_replayed_calls_count_the_eager_launches(cuda):
    """A replayed call advances the kernel wrappers' counters as the eager
    call does, and its output is the eager call's."""
    editor = _editor(cuda, 2)
    unet = editor.unet
    g = torch.Generator(device=cuda).manual_seed(2)
    sample = torch.randn((3, 16, 32, 32, 8), generator=g, device=cuda)
    t = torch.full((3,), 301, dtype=torch.int64, device=cuda)
    ctx = torch.randn((3, 77, 64), generator=g, device=cuda, dtype=torch.bfloat16)
    counters = lambda: {f.__name__: f.launches for f in tracing.kernel_wrappers()}
    with torch.no_grad():
        before = counters()
        want = unet(sample, t, ctx, video_start_index=4)
        eager = {k: v - before[k] for k, v in counters().items()}
        assert eager["flash_attention"] and eager["fused_geglu_ff"] and eager["temporal_attention"]
        editor._unet(sample, t, ctx, 4)  # captures: warm-up and replay
        before = counters()
        got = editor._unet(sample, t, ctx, 4)
        assert {k: v - before[k] for k, v in counters().items()} == eager
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _counts()[:2] == (1, 2)
