"""The SDXL-scale edit cell at a tiny size on the CPU: the float32
reference against the port through the driver's whole check of one edit
(both text towers with the pooled output, the added embedding, the VAE,
the checked 3-way UNet steps with their guidance and DDIM updates, the
decode); a run with a fault planted in the new path is not correct; the
control fails a limit; and the work plan follows the UNet3D's dispatches."""

from __future__ import annotations

import pytest
import torch

import tiny_sdxl  # noqa: I001  (puts benchmark/ on the path)
import run
from harness import benchmark_spec
from work.sdxl import unet3d_xl_launches

SPEC = benchmark_spec()
F32_TOL = 2e-4  # float32 against float32: orders of summation alone


def test_reference_matches_the_port_in_float32():
    cell = tiny_sdxl.tiny_sdxl_cell("float32")
    drv = cell.driver().Driver(cell, 2 ** 31 + 5, "cpu")
    drv.setup()
    drv.run_unit(0)
    drv.release()
    prog, _ = drv.check()
    assert set(prog) == set(cell.spec["limits"])
    assert all(v < F32_TOL for v in prog.values()), prog


def _faults():
    from insv2v_torch.models import unet3d

    real = unet3d.UNet3DConditionModel.text_time_embedding

    def no_pooled(self, added_cond):  # the pooled text left out of the added embedding
        x = real(self, added_cond).clone()
        x[:, : added_cond["text_embeds"].shape[-1]] = 0
        return x

    def no_stacks(self, x, context):  # the deepest stacks skipped
        return x if self.span_name == "unet.stack.l2" else self._forward(x, context)

    return {"the pooled text left out": (unet3d.UNet3DConditionModel, "text_time_embedding",
                                         no_pooled),
            "the deepest stacks skipped": (unet3d.Transformer3DModel, "forward", no_stacks)}


@pytest.mark.parametrize("fault", ["the pooled text left out", "the deepest stacks skipped"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    owner, name, broken = _faults()[fault]
    monkeypatch.setattr(owner, name, broken)
    result = run.run_cell(SPEC, tiny_sdxl.tiny_sdxl_cell("bfloat16"), 2 ** 31 + 17, 0.0, False,
                          device="cpu")
    assert result["correct"] is False, result["checks"]


def test_the_control_fails():
    cell = tiny_sdxl.tiny_sdxl_cell("bfloat16")
    drv = cell.driver().Driver(cell, 2 ** 31 + 23, "cpu")
    drv.setup()
    drv.run_unit(0)
    drv.release()
    prog, ctrl = drv.check(control=True)
    limits = cell.spec["limits"]
    assert any(ctrl[k] > limits[k] for k in limits), (ctrl, limits)
    assert all(ctrl[k] > prog[k] for k in limits), (prog, ctrl)


def test_plan_follows_the_programs_dispatch(monkeypatch):
    """At the tiny width, the plan's launch counts equal the calls the
    SDXL UNet3D makes into kernels A, B and C's wrappers."""
    from insv2v_torch.models import unet3d
    from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig

    cell = tiny_sdxl.tiny_sdxl_cell()
    calls = {"flash": 0, "ff": 0, "temporal": 0}
    real_attn, real_ff = unet3d.dot_attention_bshd, unet3d.geglu_ff
    real_t = unet3d.temporal_attention

    def attn(q, k, v, heads, use_flash=None):
        if use_flash is not False and q.shape[1] >= 16 and k.shape[1] >= 16:
            calls["flash"] += 1
        return real_attn(q, k, v, heads, use_flash=use_flash)

    monkeypatch.setattr(unet3d, "dot_attention_bshd", attn)
    monkeypatch.setattr(unet3d, "geglu_ff", lambda *a, **k: (calls.__setitem__(
        "ff", calls["ff"] + 1), real_ff(*a, **k))[1])
    monkeypatch.setattr(unet3d, "temporal_attention", lambda *a, **k: (calls.__setitem__(
        "temporal", calls["temporal"] + 1), real_t(*a, **k))[1])
    u = cell.config["unet"]
    model = UNet3DConditionModel(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                               for k, v in u.items()}))
    with torch.no_grad():
        model(torch.randn(1, 2, 16, 16, 8), torch.tensor([10]), torch.randn(1, 77, 16),
              added_cond={"text_embeds": torch.randn(1, 8), "time_ids": torch.ones(1, 6)})
    plan = unet3d_xl_launches(u, 1, 2, 16, 16, flash_min_seq=16)
    assert {k: len(v) for k, v in plan.items()} == calls
