"""The port's tracer (``insv2v_torch/utils/tracing.py``) and the spans it
is given: nesting, units and threads, exceptions, the bounded rings, no
device work without ``timings``, the trainer's, the loader's, the
samplers' and the GIF writer's spans, the editor's and the PTP sampler's
``timings`` keys, the train CLI's per-step fields, and on the card
(marker ``gpu``) the device tier's leads and intervals. This file imports
torch and the port only, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest
"""

import sys
import threading

import numpy as np
import pytest
import torch

from insv2v_torch.apps.train import step_host_ms
from insv2v_torch.data.native_loader import PrefetchLoader
from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.diffusion.ptp_sampler import sample_ptp_pair
from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.text.tokenizer import HashTokenizer
from insv2v_torch.training.trainer import TrainConfig, Trainer
from insv2v_torch.utils import tracing
from insv2v_torch.utils.media import save_gif

VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)


class TinyTokenizer(HashTokenizer):
    vocab_size = 100
    sot_id = 98
    eot_id = 99


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the device tier records CUDA events")
    return torch.device("cuda")


def tiny_models(seed=0):
    torch.manual_seed(seed)
    return (UNet3DConditionModel(UNetConfig.tiny()), AutoencoderKL(VaeConfig(**VAE_KW)),
            ClipTextEncoder(ClipTextConfig(**CLIP_KW)))


# --- the tracer ----------------------------------------------------------------

def test_spans_nest_with_parents_and_units_from_two_threads():
    both = threading.Barrier(2, timeout=30)  # both alive at once: two thread ids

    def work(unit):
        with tracing.span("outer", unit=unit) as outer:
            both.wait()
            for _ in range(3):
                with tracing.span("inner") as inner:
                    assert inner.parent == outer.id and inner.unit == unit
        with tracing.span("after") as after:
            assert after.parent is None and after.unit is None

    threads = [threading.Thread(target=work, args=(u,)) for u in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    outers = {r.unit: r for r in tracing.records("outer")}
    assert set(outers) == {"a", "b"} and outers["a"].thread != outers["b"].thread
    inners = tracing.records("inner")
    assert len(inners) == 6
    for r in inners:
        parent = outers[r.unit]
        assert r.parent == parent.id and r.thread == parent.thread
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        assert not r.failed and r.dev_start_ns is None and r.lead_ms is None
    snap = tracing.snapshot()
    assert snap["counts"] == {"outer": 2, "inner": 6, "after": 2}
    assert set(snap["launches"]) == {"flash_attention", "flash_attention_headfold",
                                     "fused_geglu_ff", "temporal_attention", "fused_layer_norm",
                                     "fused_group_norm"}


def test_a_span_closed_by_an_exception_is_marked_and_unwinds():
    with pytest.raises(KeyError):
        with tracing.span("step", unit=7):
            with tracing.span("child"):
                raise KeyError("stop")
    (step,), (child,) = tracing.records("step"), tracing.records("child")
    assert step.failed and child.failed and child.parent == step.id and child.unit == 7
    assert child.end_ns <= step.end_ns
    with tracing.span("next") as nxt:
        pass
    assert nxt.parent is None and nxt.unit is None and not nxt.failed


def test_the_ring_keeps_the_newest_records_and_counts_all():
    n = tracing.CAPACITY + 10
    for i in range(n):
        with tracing.span("many", unit=i):
            pass
    recs = tracing.records("many")
    assert len(recs) == tracing.CAPACITY
    assert [r.unit for r in recs] == list(range(10, n))
    assert tracing.snapshot()["counts"]["many"] == n
    assert recs[-1].unit == n - 1


def test_threads_writing_one_name_lose_no_record():
    """More threads than cores, switching often: every span lands once."""
    per, workers = 250, 16  # 4000 spans: within one ring
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with tracing.span("shared", unit=(k, i)):
                    pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    recs = tracing.records("shared")
    assert tracing.snapshot()["counts"]["shared"] == len(recs) == per * workers
    assert len({r.unit for r in recs}) == per * workers


def test_without_timings_nothing_touches_the_device(monkeypatch):
    """With ``timings=None`` no path creates a CUDA event or synchronises:
    both raise here, and the stage clock on a CUDA device, the editor,
    the PTP sampler and a training step still run."""
    def refuse(*a, **k):
        raise AssertionError("device work without timings")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with tracing.StageClock(torch.device("cuda"), None) as clock:
        with tracing.span("sampler.step"):
            clock.mark("text")
    assert tracing.records("stage.text") == []
    assert tracing.records("sampler.step")[-1].unit is not None
    run_editor(None)
    run_ptp(None)
    run_train_step()
    assert all(r.dev_start_ns is None for name in tracing.snapshot()["spans"]
               for r in tracing.records(name))


# --- the program's spans -----------------------------------------------------------

def run_train_step(accum=2):
    unet, vae, text = tiny_models()
    trainer = Trainer(unet, vae, text, TrainConfig(lr=1e-3, accumulate_grad_batches=accum))
    state = trainer.create_state()
    rs = np.random.RandomState(0)
    batch = {"input_video": torch.tensor(rs.randn(accum, 2, 16, 16, 3) * 0.3).float(),
             "edited_video": torch.tensor(rs.randn(accum, 2, 16, 16, 3) * 0.3).float(),
             "prompt_ids": torch.tensor(rs.randint(0, 50, (accum, 77)))}
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    return state, metrics


def test_train_step_spans_share_the_step():
    state, metrics = run_train_step(accum=2)
    (step,) = tracing.records("train.step")
    assert step.unit == 0 and state.step == 1 and not step.failed
    counts = {"train.encode": 2, "train.forward": 2, "train.backward": 2,
              "train.accumulate": 2, "train.optimizer": 1, "train.push_params": 1,
              "train.loss_sync": 1, "train.all_reduce": 0}
    for name, n in counts.items():
        recs = tracing.records(name)
        assert len(recs) == n, name
        for r in recs:
            assert r.unit == step.unit and r.parent == step.id, name
            assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns, name
    # the step's parts in order: encode, forward, backward, accumulate a
    # microbatch, then the optimizer, the copy and the loss
    parts = sorted((r for name in counts for r in tracing.records(name)),
                   key=lambda r: r.start_ns)
    assert [r.name.split(".")[1] for r in parts] == (
        ["encode", "forward", "backward", "accumulate"] * 2
        + ["optimizer", "push_params", "loss_sync"])
    assert np.isfinite(metrics["train_loss"])


def test_step_host_ms_reads_a_steps_spans():
    for unit, ms in ((4, 1.0), (5, 2.0)):
        for name in ("train.encode", "train.forward", "train.backward", "train.accumulate"):
            for _ in range(2):  # two microbatches
                with tracing.span(name, unit=unit) as sp:
                    pass
                sp.end_ns = sp.start_ns + int(ms * 1e6)
    for name in ("train.optimizer", "train.push_params", "train.loss_sync"):
        with tracing.span(name, unit=5) as sp:
            pass
        sp.end_ns = sp.start_ns + int(3e6)
    for i in range(3):
        with tracing.span("loader.produce", unit=i) as sp:
            pass
        sp.end_ns = sp.start_ns + int((10 + i) * 1e6)
    with tracing.span("loader.wait", unit=1) as sp:
        pass
    sp.end_ns = sp.start_ns + int(0.5e6)
    assert step_host_ms(5) == {"forward_ms": 8.0, "backward_ms": 4.0, "update_ms": 10.0,
                               "loss_sync_ms": 3.0, "loader_wait_ms": 0.5,
                               "loader_produce_ms": 11.0}


def test_prefetch_loader_spans_from_both_threads():
    made = iter(range(5))
    with PrefetchLoader(lambda: next(made), depth=2) as loader:
        got = list(loader)
    assert got == list(range(5))
    produce, wait = tracing.records("loader.produce"), tracing.records("loader.wait")
    # five batches and the call that raised StopIteration
    assert [r.unit for r in produce] == list(range(6)) and produce[-1].failed
    assert [r.unit for r in wait[:5]] == list(range(5))
    assert {r.thread for r in produce} != {r.thread for r in wait}
    assert all(w.thread == threading.get_ident() for w in wait)
    for p, w in zip(produce, wait):  # a batch is made before it is taken
        assert p.end_ns <= w.end_ns


def test_save_gif_records_its_span(tmp_path):
    frames = np.linspace(-1, 1, 4 * 8 * 8 * 3, dtype=np.float32).reshape(4, 8, 8, 3)
    save_gif(frames, str(tmp_path / "a.gif"))
    (rec,) = tracing.records("media.save_gif")
    assert rec.host_ms > 0 and not rec.failed and (tmp_path / "a.gif").exists()


def run_editor(timings):
    unet, vae, text = tiny_models()
    editor = VideoEditor(unet, vae, text, tokenizer=TinyTokenizer(), scheduler="ddim",
                         num_steps=2, device="cpu", dtype=torch.float32)
    frames = np.random.RandomState(0).uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        return editor(frames, "make it snowy", frames_per_window=4, num_ref_frames=2,
                      timings=timings)


def test_editor_timings_keys_and_sampler_spans():
    timings = {}
    out = run_editor(timings)
    assert out.shape == (6, 16, 16, 3)
    assert list(timings) == ["text", "vae_encode", "window_0", "window_1", "vae_decode"]
    assert all(v > 0 for v in timings.values())
    steps, unets = tracing.records("sampler.step"), tracing.records("sampler.unet")
    assert len(steps) == len(unets) == 4  # two windows of two steps
    units = {r.unit for r in steps}
    assert len(units) == 1 and None not in units
    ids = {s.id for s in steps}
    assert all(u.parent in ids for u in unets)
    for stage, secs in timings.items():
        (rec,) = tracing.records("stage." + stage)
        assert rec.unit in units and rec.end_ns - rec.start_ns == round(secs * 1e9)
    run_editor(None)  # a second call: a unit of its own
    assert len({r.unit for r in tracing.records("sampler.step")}) == 2


def run_ptp(timings):
    tables = make_sampler_tables(DiffusionSchedule.create(), 5, kind="ddim")
    g = torch.Generator().manual_seed(0)
    lat = torch.randn((1, 2, 4, 4, 4), generator=g)
    ctx = [torch.randn((1, 3, 8), generator=g) for _ in range(5)]
    unet = lambda x, t, c, share: 0.1 * x
    return sample_ptp_pair(unet, tables, lat, ctx[0], ctx[1], (ctx[2], ctx[3]), ctx[4],
                           sa_steps=2, ca_steps=4, timings=timings)


def test_ptp_timings_keys_and_sampler_spans():
    timings = {}
    run_ptp(timings)
    assert list(timings) == ["phase1", "phase2", "phase3"]
    steps = tracing.records("sampler.step")
    assert len(steps) == len(tracing.records("sampler.unet")) == 5
    assert len({r.unit for r in steps}) == 1


# --- on the card ---------------------------------------------------------------------

@pytest.mark.gpu
def test_device_tier_leads_and_intervals(cuda):
    """A stage clock with ``timings`` on the card: every span gets a
    device interval on the host's clock inside its stage, no lead is
    negative, a span's device ms matches a pair of events recorded inside
    it, and as the host queues work ahead the lead grows as the device
    intervals say it must (a step cannot start on the device before the
    steps queued ahead of it end)."""
    x = torch.randn(4096, 4096, device=cuda)
    (x @ x).clamp_(-1, 1)  # load cuBLAS's kernels before the clock
    torch.cuda.synchronize()
    inner = []
    timings = {}
    with tracing.StageClock(cuda, timings) as clock:
        for _ in range(12):
            with tracing.span("sampler.step") as sp:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(4):
                    x = (x @ x).clamp_(-1, 1)
                e1.record()
            inner.append((sp, e0, e1))
        clock.mark("window_0")
    (stage,) = tracing.records("stage.window_0")
    steps = tracing.records("sampler.step")
    assert len(steps) == 12
    for sp, e0, e1 in inner:
        assert sp.dev_start_ns is not None and sp.lead_ms >= 0
        assert sp.dev_start_ns <= sp.dev_end_ns <= stage.end_ns + 1_000_000
        assert sp.device_ms == pytest.approx(e0.elapsed_time(e1), rel=0.02, abs=0.05)
    for prev, nxt in zip(steps, steps[1:]):
        assert nxt.dev_start_ns >= prev.dev_end_ns - 10_000  # one stream: in turn
    first, last = steps[0], steps[-1]
    queued = sum(s.device_ms for s in steps[:-1])
    host_gap = (last.start_ns - first.start_ns) / 1e6
    assert last.lead_ms > first.lead_ms
    assert last.lead_ms >= first.lead_ms + queued - host_gap - 0.5
    with tracing.span("untimed") as sp:
        (x @ x).sum()
    assert sp.dev_start_ns is None
