"""A whole run of each cell at a tiny size on the CPU, past the look for a
chip (``run.run_cell``), with the timed path broken underneath: each
fault the cell can have must turn ``correct`` false. And the control, the
reference one precision lower (fp8) in the program's place, must fail at
least one of the cell's limits and read above the program on every
number it holds."""

from __future__ import annotations

import pytest
import torch

import tiny
import faults
import run
from harness import benchmark_spec

SPEC = benchmark_spec()


def _half_frames(forward):
    """A model call that computes half of its frames and fills the rest
    with their mean."""
    def broken(self, x, *a, **k):
        out = forward(self, x, *a, **k)
        half = out.shape[1] // 2
        return torch.cat([out[:, :half], out[:, :half].mean(1, keepdim=True).expand_as(
            out[:, half:])], dim=1)
    return broken


def _edit_faults():
    from insv2v_torch.diffusion import pipeline, samplers
    from insv2v_torch.models import unet3d

    def decode_negated(real):
        def broken(self, latents, chunk=8):
            out = real(self, latents, chunk)
            out[0] = -out[0]
            return out
        return broken

    def flipped(real):  # a window's output written into its frames in reverse
        def broken(*a, **k):
            out = real(*a, **k)
            return dict(out, latent=out["latent"].flip(1))
        return broken

    return {
        "a window written into the wrong frames": (
            pipeline, "sample_video_window", flipped(pipeline.sample_video_window)),
        "step returns its state": (samplers, "sampler_step",
                                   lambda tables, x, eps, i, noise=None: (x.float(), x.float())),
        "half the batch, the mean over the rest": (
            unet3d.UNet3DConditionModel, "forward",
            _half_frames(unet3d.UNet3DConditionModel.forward)),
        "an answer altered where it is produced": (
            pipeline.VideoEditor, "decode_latents",
            decode_negated(pipeline.VideoEditor.decode_latents)),
    }


def _datagen_faults():
    from insv2v_torch.diffusion import ptp_sampler
    from insv2v_torch.models import modelscope_t2v
    from insv2v_torch.utils import clip_metrics

    def shifted(real):
        def broken(self, *a, **k):
            out = real(self, *a, **k)
            out["sim_direction"] = out["sim_direction"] + 0.05
            return out
        return broken

    return {
        "step returns its state": (ptp_sampler, "sampler_step",
                                   lambda tables, x, eps, i, noise=None: (x.float(), x.float())),
        "half the batch, the mean over the rest": (
            modelscope_t2v.UNetSD, "forward", _half_frames(modelscope_t2v.UNetSD.forward)),
        "an answer altered where it is produced": (
            clip_metrics.ClipSimilarity, "__call__", shifted(clip_metrics.ClipSimilarity.__call__)),
    }


def _train_faults():
    from insv2v_torch.training import trainer

    real_step = trainer.Trainer.train_step

    def unchanged(self, state, batch, generator=None, draws=None):
        loss, _ = self.accumulate_grads(state, batch, generator, draws)
        state.step += 1
        return state, {"train_loss": float(loss)}

    def altered(self, *a, **k):  # the step's answer, its first motion tensor, moved
        state, metrics = real_step(self, *a, **k)
        next(iter(state.params.values())).add_(0.01)
        return state, metrics

    return {"step returns its state": (trainer.Trainer, "train_step", unchanged),
            "half the batch, the mean over the rest": faults.half_batch(),
            "an answer altered where it is produced": (trainer.Trainer, "train_step", altered)}


CASES = [(tiny.tiny_edit_cell, _edit_faults, f) for f in
         ("a window written into the wrong frames", "step returns its state", "half the batch, the mean over the rest",
          "an answer altered where it is produced")] + \
        [(tiny.tiny_datagen_cell, _datagen_faults, f) for f in
         ("step returns its state", "half the batch, the mean over the rest",
          "an answer altered where it is produced")] + \
        [(tiny.tiny_train_cell, _train_faults, f) for f in
         ("step returns its state", "half the batch, the mean over the rest",
          "an answer altered where it is produced")]


@pytest.mark.parametrize("make,faults,fault", CASES,
                         ids=[f"{m.__name__}-{f}" for m, _, f in CASES])
def test_a_planted_fault_is_not_correct(make, faults, fault, monkeypatch):
    owner, name, broken = faults()[fault]
    monkeypatch.setattr(owner, name, broken)
    result = run.run_cell(SPEC, make(), 2 ** 31 + 17, 0.0, False, device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("make", [tiny.tiny_edit_cell, tiny.tiny_datagen_cell,
                                  tiny.tiny_train_cell], ids=["edit", "datagen", "train"])
def test_the_control_fails(make):
    cell = make()
    drv = cell.driver().Driver(cell, 2 ** 31 + 23, "cpu")
    drv.setup()
    if drv.unit != "step":  # training's checked steps run in its set-up
        drv.run_unit(0)
    drv.release()
    prog, ctrl = drv.check(control=True)
    limits = cell.spec["limits"]
    assert any(ctrl[k] > limits[k] for k in limits), (ctrl, limits)
    # an exact comparison (limit 0: the training batches) has no control
    # reading; nor has the training's change: Adam's first step moves each
    # element by about the learning rate whatever its gradient's precision,
    # so the change is held by a state left unchanged, not by the control
    held = [k for k in limits if limits[k] > 0 and not (cell.spec["driver"] == "train"
                                                        and k == "change")]
    assert all(ctrl[k] > prog[k] for k in held), (prog, ctrl)
