"""The trainer's CUDA-graph replay (``models/graphed_call.py``, backward
mode) against its eager call on the card
(marker ``gpu``; they skip on a machine without one). This file imports
torch and the port only, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu_graphs.py -m gpu --noconftest

A UNet3D at the kernels' widths (320 and 640, so that A', B and C all
launch) with one layer a level, remat on and kernel A' on, a VAE whose
mid-block attention runs kernel A at d = 64, and a one-layer CLIP text
encoder, all in bf16 from one seed. The eager side is the same trainer
with its UNet call swapped for the model's own."""

import copy
import functools
import threading
import time

import pytest
import torch

from insv2v_torch.data.native_loader import PrefetchLoader
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.graphed_call import graphs_of
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import attention
from insv2v_torch.training.trainer import TrainConfig, Trainer
from insv2v_torch.utils import tracing

pytestmark = pytest.mark.gpu

FRAMES, SIZE, ACCUM = 4, 32, 2  # latents of 16x16: A' at S = 256 on level 0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(cuda):
    """(unet, vae, text) in bf16 on the card, every tensor drawn from one
    seed (no zero-initialised projection, so every motion leaf has a
    gradient)."""
    gen = torch.Generator().manual_seed(0)
    out = (UNet3DConditionModel(UNetConfig(
               block_out_channels=(320, 640), down_block_types=("CrossAttnDownBlock3D",
                                                                "DownBlock3D"),
               up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"), layers_per_block=1,
               cross_attention_dim=64, motion_module_resolutions=(1, 2), remat=True)),
           AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)),
           ClipTextEncoder(ClipTextConfig(hidden_size=64, num_layers=1, num_heads=2,
                                          intermediate_size=128)))
    with torch.no_grad():
        for m in out:
            for name, p in m.named_parameters():
                if p.ndim >= 2:
                    p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
                else:
                    base = 1.0 if name.endswith("weight") else 0.0
                    p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
    return tuple(m.to(cuda, torch.bfloat16) for m in out)


@pytest.fixture(scope="module", autouse=True)
def headfold():
    old, attention.FLASH_HEADFOLD = attention.FLASH_HEADFOLD, True  # A', as training runs
    yield
    attention.FLASH_HEADFOLD = old


def _trainer(models, eager: bool, lr: float = 1e-2, meta_built: bool = False,
             autocast: bool = False) -> Trainer:
    """A trainer over a copy of the models; ``eager`` calls the UNet as it
    is. lr 1e-2 moves the bf16 parameters at the first push.
    ``meta_built`` builds the UNet on the meta device and hands it a copy
    of the weights with ``assign=True`` (its PE tables are made on the
    host); ``autocast`` stores the models in float32 and computes under
    bf16 autocast."""
    unet, vae, text = (copy.deepcopy(m) for m in models)
    if meta_built:
        with torch.device("meta"):
            built = UNet3DConditionModel(unet.cfg)
        built.load_state_dict(unet.state_dict(), strict=True, assign=True)
        unet = built
    if autocast:
        unet, vae, text = unet.float(), vae.float(), text.float()
    trainer = Trainer(unet, vae, text, TrainConfig(
        lr=lr, accumulate_grad_batches=ACCUM, compute_dtype="bfloat16" if autocast else None))
    if eager:
        trainer.unet_call = functools.partial(unet, split_skip=False)
    return trainer


def _batch(seed: int, frames: int = FRAMES, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (ACCUM, frames, SIZE, SIZE, 3)
    return {"input_video": torch.rand(shape, generator=g, device=device) * 2 - 1,
            "edited_video": torch.rand(shape, generator=g, device=device) * 2 - 1,
            "prompt_ids": torch.randint(0, 49408, (ACCUM, 77), generator=g, device=device)}


def _gen(seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def _counters():
    return {f.__name__: f.launches for f in tracing.kernel_wrappers()}


def _marked(trainer, marks):
    """Record the launch counters as each microbatch starts."""
    real = trainer.microbatch_loss

    def marked(*a, **k):
        marks.append(_counters())
        return real(*a, **k)

    trainer.microbatch_loss = marked


def _advances(marks):
    return [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]


def _run(trainer, batch):
    """The first gradient (``accumulate_grads``), then two optimizer steps
    on the same batch and draws; every microbatch's launch advance."""
    state = trainer.create_state()
    marks = []
    _marked(trainer, marks)
    loss0, grads = trainer.accumulate_grads(state, batch, _gen(1))
    out = {"loss0": float(loss0), "grads": [g.clone() for g in grads], "losses": [],
           "masters": []}
    for _ in range(2):
        _, m = trainer.train_step(state, batch, _gen(2))
        out["losses"].append(m["train_loss"])
        out["masters"].append([p.clone() for p in state.params.values()])
    marks.append(_counters())
    out["advances"] = _advances(marks)
    return out


@pytest.fixture(scope="module")
def both(models):
    tracing.clear()
    batch = _batch(3)
    trainer = _trainer(models, eager=False)
    graphed = _run(trainer, batch)
    graphed["captures"] = tracing.count("train.graph_capture")
    graphed["replays"] = tracing.count("train.graph_replay")
    (captured,) = graphs_of(trainer.unet).captured.values()
    graphed["replay_launches"] = {k: v + captured.bwd_launches[k]
                                  for k, v in captured.fwd_launches.items()}
    eager = _run(_trainer(models, eager=True), batch)
    return graphed, eager


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def test_graphed_step_matches_eager(both):
    """Losses, the first gradient and the masters after each of two steps,
    graphed against eager from the same weights, draws and batch: within
    1e-6 relative (the same kernels on the same inputs: equal)."""
    graphed, eager = both
    assert graphed["captures"] == 1 and graphed["replays"] == 3 * ACCUM
    assert abs(graphed["loss0"] - eager["loss0"]) <= 1e-6 * abs(eager["loss0"])
    for a, b in zip(graphed["losses"], eager["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert sum(float(g.norm()) > 0 for g in eager["grads"]) > len(eager["grads"]) // 2
    assert max(_rel(a, b) for a, b in zip(graphed["grads"], eager["grads"])) <= 1e-6
    for step_a, step_b in zip(graphed["masters"], eager["masters"]):
        assert max(_rel(a, b) for a, b in zip(step_a, step_b)) <= 1e-6
    print("equal:", graphed["loss0"] == eager["loss0"], graphed["losses"] == eager["losses"],
          all(torch.equal(a, b) for a, b in zip(graphed["grads"], eager["grads"])))


def test_replay_reads_the_pushed_parameters(both):
    """The second step runs the first step's batch and draws: its loss
    differs from the first's only through the parameters the first pushed,
    and the graphed step's equals the eager step's."""
    graphed, eager = both
    assert graphed["losses"][1] != graphed["losses"][0]
    assert abs(graphed["losses"][1] - eager["losses"][1]) <= 1e-6 * abs(eager["losses"][1])


def test_launch_counters_count_replays(both):
    """Each kernel's ``.launches`` advances as much in every replayed
    microbatch as in the eager one; the capturing microbatch adds its
    warm-up (an eager UNet forward and backward, which launches what a
    replay launches) and nothing for the capture."""
    graphed, eager = both
    assert len(graphed["advances"]) == len(eager["advances"]) == 3 * ACCUM
    per = eager["advances"][0]
    assert all(a == per for a in eager["advances"])
    assert per["flash_attention_headfold"] > 0 and per["fused_geglu_ff"] > 0
    assert per["temporal_attention"] > 0 and per["flash_attention"] > 0
    unet = graphed["replay_launches"]
    assert unet["flash_attention_headfold"] == per["flash_attention_headfold"]
    assert unet["flash_attention"] == 0  # A at d = 64 runs in the VAE encodes alone
    assert graphed["advances"][0] == {k: v + unet[k] for k, v in per.items()}
    assert graphed["advances"][1:] == eager["advances"][1:]


def test_new_shape_captures_anew(models):
    """Another frame count is another key: one more capture, and its step
    equals the eager one; the first shape's graphs serve it again after.
    The UNet is built on the meta device and handed its weights: its PE
    tables follow the weights to the card, so the capture reads them there."""
    tracing.clear()
    graphed = _trainer(models, eager=False, meta_built=True)
    eager = _trainer(models, eager=True, meta_built=True)
    assert all(b.is_cuda for b in graphed.unet.buffers())
    states = graphed.create_state(), eager.create_state()
    losses = []
    for frames, seed in ((FRAMES, 4), (2, 5), (FRAMES, 6)):
        batch = _batch(seed, frames)
        losses.append([t.train_step(s, batch, _gen(seed))[1]["train_loss"]
                       for t, s in zip((graphed, eager), states)])
        if frames == 2:
            assert tracing.count("train.graph_capture") == 2
    assert tracing.count("train.graph_capture") == 2
    assert tracing.count("train.graph_replay") == 3 * ACCUM
    assert len(graphs_of(graphed.unet).captured) == 2
    for a, b in losses:
        assert abs(a - b) <= 1e-6 * abs(b)


def test_autocast_step_matches_eager(models):
    """Models stored in float32 computing under bf16 autocast: the capture
    runs under the same autocast with its weight cache off, and two
    graphed steps equal the eager ones."""
    tracing.clear()
    graphed = _trainer(models, eager=False, autocast=True)
    eager = _trainer(models, eager=True, autocast=True)
    states = graphed.create_state(), eager.create_state()
    batch = _batch(8)
    for step in range(2):
        got, want = (t.train_step(s, batch, _gen(8 + step))[1]["train_loss"]
                     for t, s in zip((graphed, eager), states))
        assert abs(got - want) <= 1e-6 * abs(want)
    assert max(_rel(a, b) for a, b in zip(states[0].params.values(),
                                          states[1].params.values())) <= 1e-6
    assert tracing.count("train.graph_capture") == 1
    assert tracing.count("train.graph_replay") == 2 * ACCUM


def test_capture_beside_a_pinning_loader(models):
    """The capture runs while a ``PrefetchLoader`` thread pins host memory
    (thread-local capture mode: the thread's CUDA calls do not break it),
    and the step matches the eager one."""
    tracing.clear()
    pins = []
    stop = threading.Event()

    def batch_fn():
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end and not stop.is_set():
            torch.empty((1 + len(pins) % 5) << 18).pin_memory()
            pins.append(time.perf_counter_ns())
        return {k: v.pin_memory() for k, v in _batch(7, device="cpu").items()}

    graphed, eager = _trainer(models, eager=False), _trainer(models, eager=True)
    states = graphed.create_state(), eager.create_state()
    loader = PrefetchLoader(batch_fn, depth=2)
    try:
        batch = {k: v.to("cuda", non_blocking=True) for k, v in next(loader).items()}
        loss = graphed.train_step(states[0], batch, _gen(7))[1]
    finally:
        stop.set()
        loader.close()
    want = eager.train_step(states[1], batch, _gen(7))[1]
    (cap,) = tracing.records("train.graph_capture")
    assert any(cap.start_ns <= t <= cap.end_ns for t in pins)
    assert abs(loss["train_loss"] - want["train_loss"]) <= 1e-6 * abs(want["train_loss"])
