"""The trainer's CUDA-graph path where the CPU can check it: a CPU trainer
calls its UNet as it always did and captures nothing, and a replay's
launch-count bookkeeping, driven by stand-in graph objects, adds exactly
the captured advances and nothing for the capture. The replays on the
card: ``tests/test_torch_gpu_graphs.py``."""

import dataclasses
import functools

import torch

from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import attention, fused_ff, norms
from insv2v_torch.training.cuda_graphs import (Captured, GraphedCall, _Replay, add_launches,
                                               counted_capture)
from insv2v_torch.training.trainer import TrainConfig, Trainer
from insv2v_torch.utils import tracing


def _counters():
    return {f.__name__: f.launches for f in tracing.kernel_wrappers()}


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
    tracing.clear()
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
    assert not graphed.unet_call.captured
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


class _StandIn:
    """A graph's stand-in: ``replay()`` runs the given function."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


def test_replay_bookkeeping_adds_the_captured_launches():
    """A capture moves no counter and reports what its body launched; each
    forward replay adds the forward capture's advance, each backward replay
    the backward capture's; the replayed call's gradient reaches the
    parameter through the autograd function."""
    def forward_body():  # what the wrappers count while a forward is captured
        attention.flash_attention_headfold.launches += 3
        fused_ff.fused_geglu_ff.launches += 2
        return "out"

    def backward_body():  # remat's reruns launch the forward's kernels again
        attention.flash_attention_headfold.launches += 3
        fused_ff.fused_geglu_ff.launches += 2
        attention.temporal_attention.launches += 1
        return "grads"

    before = _counters()
    assert counted_capture(forward_body) == ("out", {**{k: 0 for k in before},
                                                     "flash_attention_headfold": 3,
                                                     "fused_geglu_ff": 2})
    _, bwd_launches = counted_capture(backward_body)
    assert _counters() == before  # a capture launches nothing
    _, fwd_launches = counted_capture(forward_body)

    w = torch.nn.Parameter(torch.tensor([2.0, -1.0]))
    x_static, out, g_static, g_w = torch.zeros(2), torch.zeros(2), torch.zeros(2), torch.zeros(2)
    fwd = _StandIn(lambda: out.copy_(x_static * w.detach()))
    bwd = _StandIn(lambda: g_w.copy_(g_static * x_static))
    captured = Captured(fwd, bwd, [x_static], out, g_static, [g_w], fwd_launches, bwd_launches)
    tracing.clear()
    x = torch.tensor([3.0, 5.0])
    for i in range(1, 3):
        pred = _Replay.apply(captured, x, w)
        assert torch.equal(pred, x * w.detach())
        (grad,) = torch.autograd.grad((pred * torch.tensor([1.0, 10.0])).sum(), [w])
        assert torch.equal(grad, torch.tensor([3.0, 50.0]))
        assert fwd.replays == bwd.replays == i
        now = _counters()
        assert {k: now[k] - before[k] for k in now} == {
            k: i * (fwd_launches[k] + bwd_launches[k]) for k in now}
    assert tracing.count("train.graph_replay") == 2
    add_launches({k: before[k] - now[k] for k in now})  # leave the counters as found
    assert _counters() == before


def test_key_follows_what_the_call_observes():
    """The remat switch of ``unet.cfg``, a submodule's train/eval flag and
    each kernel dispatch switch are part of a graph's key: changing one
    gives another key, and setting it back gives the first again."""
    unet = UNet3DConditionModel(UNetConfig.tiny(remat=True))
    call = GraphedCall(functools.partial(unet, split_skip=False), unet)
    inputs = (torch.zeros((1, 2, 8, 8, 8)), torch.zeros(1, dtype=torch.long),
              torch.zeros((1, 77, 32)))
    first = call._key(inputs)

    def remat_off():
        unet.cfg = dataclasses.replace(unet.cfg, remat=False)
        return lambda: setattr(unet, "cfg", dataclasses.replace(unet.cfg, remat=True))

    def one_eval():
        next(iter(unet.children())).eval()
        return lambda: unet.train()

    def flip(module, name):
        def change():
            old = getattr(module, name)
            setattr(module, name, not old)
            return lambda: setattr(module, name, old)
        return change

    for change in (remat_off, one_eval, flip(attention, "FLASH_HEADFOLD"),
                   flip(norms, "FUSED_LAYER_NORM")):
        undo = change()
        try:
            assert call._key(inputs) != first
        finally:
            undo()
        assert call._key(inputs) == first


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
