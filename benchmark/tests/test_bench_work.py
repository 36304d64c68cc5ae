"""The work functions against hand counts, two shapes a kernel, and the
launch plans of a model call against the program's own counters."""

from __future__ import annotations

import pytest
import torch

import tiny
from harness import Cell
from work import kernels as wk


@pytest.mark.parametrize("shape,flops,nbytes", [
    # 4 B H Sq Sk d; q, k, v, o at 2 bytes
    ((48, 8, 1536, 1536, 40), 4 * 48 * 8 * 1536 * 1536 * 40, 2 * 48 * 8 * 40 * 4 * 1536),
    ((64, 5, 1024, 1024, 64), 4 * 64 * 5 * 1024 ** 2 * 64, 2 * 64 * 5 * 64 * 4 * 1024),
])
def test_flash(shape, flops, nbytes):
    assert wk.flash(*shape) == (flops, nbytes)


@pytest.mark.parametrize("rows,c,flops,nbytes", [
    # W1 (C x 8C) and W2 (4C x C): 2 * rows * 12 C^2; x in, out; weights and biases once
    (73728, 320, 2 * 73728 * 12 * 320 ** 2,
     2 * (2 * 73728 * 320 + 320 * 2560 + 2560 + 1280 * 320 + 320 + 640)),
    (1024, 1280, 2 * 1024 * 12 * 1280 ** 2,
     2 * (2 * 1024 * 1280 + 1280 * 10240 + 10240 + 5120 * 1280 + 1280 + 2560)),
])
def test_geglu_ff(rows, c, flops, nbytes):
    assert wk.geglu_ff(rows, c, 4 * c) == (flops, nbytes)


@pytest.mark.parametrize("shape,flops,nbytes", [
    ((3 * 1536, 16, 8, 40), 4 * 4608 * 8 * 256 * 40, 2 * 4 * 4608 * 16 * 8 * 40),
    ((96, 16, 8, 160), 4 * 96 * 8 * 256 * 160, 2 * 4 * 96 * 16 * 8 * 160),
])
def test_temporal(shape, flops, nbytes):
    assert wk.temporal(*shape) == (flops, nbytes)


def test_edit_unet_call_plan():
    """One 3-way UNet3D call of the edit (16 frames of 32x48 latents):
    A at levels 0 and 1 (5 blocks each), B in 16 spatial and 20 motion
    FFs, C twice in each of the 20 motion modules."""
    cfg = Cell.load(tiny.EDIT).config["unet"]
    plan = wk.unet3d_launches(cfg, 3, 16, 32, 48)
    assert len(plan["flash"]) == 10 and len(plan["ff"]) == 36 and len(plan["temporal"]) == 40
    assert plan["flash"].count(wk.flash(48, 8, 1536, 1536, 40)) == 5
    assert plan["flash"].count(wk.flash(48, 8, 384, 384, 80)) == 5


def test_unetsd_call_plan():
    """A 4-way UNetSD call (16 frames of 32x32): A at d = 64 in the 5 blocks
    of levels 0 (S = 1024) and 1 (S = 256)."""
    cfg = Cell.load(tiny.DATAGEN).config["unet"]
    plan = wk.unetsd_launches(cfg, 4, 16, 32, 32)
    assert plan["flash"] == [wk.flash(64, 5, 1024, 1024, 64)] * 5 + [wk.flash(64, 10, 256, 256, 64)] * 5


def test_plans_follow_the_programs_dispatch(monkeypatch):
    """At a tiny width, the plan's launch counts equal the calls the
    program's UNet3D makes into kernels A, B and C's wrappers."""
    from insv2v_torch.models import unet3d
    from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig

    cell = tiny.tiny_edit_cell()
    calls = {"flash": 0, "ff": 0, "temporal": 0}
    real_attn, real_ff, real_t = unet3d.dot_attention_bshd, unet3d.geglu_ff, unet3d.temporal_attention

    def attn(q, k, v, heads, use_flash=None):
        if use_flash is not False and q.shape[1] >= 16 and k.shape[1] >= 16:
            calls["flash"] += 1
        return real_attn(q, k, v, heads, use_flash=use_flash)

    monkeypatch.setattr(unet3d, "dot_attention_bshd", attn)
    monkeypatch.setattr(unet3d, "geglu_ff", lambda *a, **k: (calls.__setitem__(
        "ff", calls["ff"] + 1), real_ff(*a, **k))[1])
    monkeypatch.setattr(unet3d, "temporal_attention", lambda *a, **k: (calls.__setitem__(
        "temporal", calls["temporal"] + 1), real_t(*a, **k))[1])
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.config["unet"].items()}
    model = UNet3DConditionModel(UNetConfig(**cfg))
    with torch.no_grad():
        model(torch.randn(1, 2, 8, 8, 8), torch.tensor([10]), torch.randn(1, 77, 12))
    plan = wk.unet3d_launches(cell.config["unet"], 1, 2, 8, 8, flash_min_seq=16)
    assert {k: len(v) for k, v in plan.items()} == calls
