"""The SDXL-scale configuration of the port (configs/insv2v_sdxl.yaml)
against the benchmark's plain float32 reference
(benchmark/reference/insv2v_sdxl.py, which imports nothing of the port),
on the CPU at a tiny SDXL shape with seeded weights: three levels, the
first without attention, transformer depth (0, 2, 3), heads 8 wide, both
text towers, the ``text_time`` embedding and one guided DDIM step. Also
the flagship SD-1.5 UNet3D's state-dict layout and per-call kernel
dispatches, unchanged, and the work plan of the SDXL UNet3D's kernels
against its dispatches, both at full size on the meta device.

Tolerances: 2e-5 where the port and the reference compute the same
float32 operations in another order (a few dozen layers: a few ulps a
layer); 1e-4 for the UNet's output and the guided step, over ~40
residual blocks and a DDIM update that divides by sqrt(alpha_t)."""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from insv2v_torch.diffusion.samplers import sample_video_window
from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
from insv2v_torch.models import unet3d
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder, DualTextEncoder
from insv2v_torch.models.openclip_text import OpenClipTextConfig, OpenClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.utils.config import load_config
from insv2v_torch.utils.factory import unet_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from harness import seeded_weights  # noqa: E402
from reference import insv2v as ref  # noqa: E402
from reference import insv2v_sdxl as xl  # noqa: E402
from reference.ops import rel  # noqa: E402
from work.kernels import unet3d_launches  # noqa: E402
from work.sdxl import unet3d_xl_launches  # noqa: E402

SAME_OPS = 2e-5
DEEP = 1e-4

TINY = dict(block_out_channels=(8, 16, 32),
            down_block_types=("DownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D"),
            up_block_types=("CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "UpBlock3D"),
            attention_head_dim=(1, 2, 4), transformer_layers_per_block=(0, 2, 3),
            cross_attention_dim=16, use_linear_projection=True, addition_embed_type="text_time",
            addition_time_embed_dim=8, projection_class_embeddings_input_dim=8 + 6 * 8,
            norm_num_groups=4, motion_module_resolutions=(1, 2, 4), motion_num_attention_heads=2)
CLIP = dict(hidden_size=8, num_layers=2, num_heads=2, intermediate_size=16, penultimate=True)
BIGG = dict(width=8, num_layers=3, num_heads=2, penultimate=True, final_norm=False,
            projection_dim=8)


def ref_cfg(cfg: UNetConfig) -> dict:
    """The reference's configuration dict of a ``UNetConfig``."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in vars(cfg).items()}


def sdxl_config() -> UNetConfig:
    yaml = load_config(os.path.join(REPO, "configs", "insv2v_sdxl.yaml"))
    return unet_config(yaml["unet"]["params"])


def seeded(module, seed: int):
    """``module`` with the benchmark's seeded float32 weights; those weights."""
    w = seeded_weights(module, seed, "cpu", torch.float32)
    module.load_state_dict(w)
    return module.eval(), w


@pytest.fixture(scope="module")
def tiny_unet():
    torch.manual_seed(0)
    return seeded(UNet3DConditionModel(UNetConfig(**TINY)), 11)


@pytest.fixture(scope="module")
def tiny_text():
    torch.manual_seed(0)
    return seeded(DualTextEncoder(ClipTextEncoder(ClipTextConfig(**CLIP)),
                                  OpenClipTextEncoder(OpenClipTextConfig(**BIGG))), 12)


def inputs(b: int = 3, f: int = 4, hw: int = 16, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g)
    return {"sample": n(b, f, hw, hw, 8), "t": torch.tensor([981, 500, 1])[:b],
            "ctx": n(b, 77, 16), "pooled": n(b, 8),
            "ids": torch.tensor([[768.0, 640, 0, 0, 768, 640]]).expand(b, 6)}


def test_sdxl_yaml_builds_the_published_shapes():
    """configs/insv2v_sdxl.yaml as utils/factory.py reads it: the SDXL UNet
    at 2.567 B parameters, 0.237 B more in the motion modules, 70 spatial
    transformer blocks (depth 1/2/10 by level, the mid block at 10)."""
    cfg = sdxl_config()
    with torch.device("meta"):
        sd = UNet3DConditionModel(cfg).state_dict()
    motion = sum(v.numel() for k, v in sd.items() if "motion_modules." in k)
    spatial = sum(v.numel() for k, v in sd.items() if "motion_modules." not in k)
    assert (round(spatial / 1e6), round(motion / 1e6)) == (2567, 237)
    assert sum(k.endswith("attn1.to_q.weight") for k in sd) == 70
    assert sd["mid_block.attentions.0.proj_in.weight"].shape == (1280, 1280)
    assert sd["add_embedding.linear_1.weight"].shape == (1280, 2816)
    assert sd["down_blocks.2.attentions.1.transformer_blocks.9.attn2.to_k.weight"].shape == (
        1280, 2048)
    assert "down_blocks.2.downsamplers.0.conv.weight" not in sd


def test_tiny_unet_matches_the_reference(tiny_unet):
    model, w = tiny_unet
    x = inputs()
    with torch.no_grad():
        got = model(x["sample"], x["t"], x["ctx"], 2,
                    added_cond={"text_embeds": x["pooled"], "time_ids": x["ids"]})
        want = xl.unet3d(w, ref_cfg(model.cfg), x["sample"], x["t"], x["ctx"], 2, x["pooled"],
                         x["ids"])
    assert rel(got, want) < DEEP


def test_text_time_embedding_matches_the_reference(tiny_unet):
    model, w = tiny_unet
    x = inputs()
    with torch.no_grad():
        got = model.add_embedding(model.text_time_embedding(
            {"text_embeds": x["pooled"], "time_ids": x["ids"]}))
        want = xl.add_embed(w, ref_cfg(model.cfg), x["pooled"], x["ids"])
    assert rel(got, want) < SAME_OPS


def test_towers_penultimate_states_and_pooled_output(tiny_text):
    model, w = tiny_text
    ids = torch.as_tensor(ref.hash_token_ids(["make the street snowy", ""]))
    with torch.no_grad():
        ctx, pooled = model(ids)
        want_ctx, want_pooled = xl.text({k: xl.sub_weights(w, k + ".") for k in
                                         ("text_encoder", "text_encoder_2")}, ids,
                                        {"clip": CLIP, "openclip": BIGG})
        # the first tower stops a layer short of its last and skips its final norm
        normed = model.text_encoder.text_model.final_layer_norm(ctx[..., :8])
    assert ctx.shape == (2, 77, 16) and pooled.shape == (2, 8)
    assert rel(ctx, want_ctx) < SAME_OPS and rel(pooled, want_pooled) < SAME_OPS
    assert rel(ctx[..., :8], normed) > 0.01


def test_one_guided_ddim_step_matches_the_reference(tiny_unet):
    model, w = tiny_unet
    tables = make_sampler_tables(DiffusionSchedule.create(), 4, kind="ddim")
    g = torch.Generator().manual_seed(5)
    lat, cond = (torch.randn(1, 4, 16, 16, 4, generator=g) for _ in range(2))
    ctx, pooled = torch.randn(2, 77, 16, generator=g), torch.randn(2, 8, generator=g)
    ids = xl.size_ids(128, 128)
    added = ({"text_embeds": pooled[1:], "time_ids": ids},
             {"text_embeds": pooled[:1], "time_ids": ids})
    call = lambda s, t, c, start, a: model(s, t, c, start, added_cond=a)
    with torch.no_grad():
        got = sample_video_window(call, tables, lat, cond, ctx[:1], ctx[1:], text_cfg=7.5,
                                  img_cfg=1.2, added_cond=added, return_all=True)["all_latent"][0]
        want = xl.edit_step(w, ref_cfg(model.cfg), ref.ddim_tables(4), 0, lat, cond, ctx[1:],
                            ctx[:1], pooled[1:], pooled[:1], ids, 0)[2]
    assert rel(got, want) < DEEP


def _dispatches(monkeypatch):
    """Calls of the UNet3D into kernels A, B and C's wrappers, as the CUDA
    path would launch them (A at S >= 256 on both sides). On the meta
    device, where autocast (the plain attention's float32 guard) has no
    place, an attention call stands in an empty output of its shape."""
    calls = {"flash": 0, "ff": 0, "temporal": 0}
    real_attn, real_ff = unet3d.dot_attention_bshd, unet3d.geglu_ff
    real_t = unet3d.temporal_attention

    def attn(q, k, v, heads, use_flash=None):
        if use_flash is not False and q.shape[1] >= 256 and k.shape[1] >= 256:
            calls["flash"] += 1
        if q.is_meta:
            return torch.empty_like(q)
        return real_attn(q, k, v, heads, use_flash=use_flash)

    def count(name, real):
        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(unet3d, "dot_attention_bshd", attn)
    monkeypatch.setattr(unet3d, "geglu_ff", count("ff", real_ff))
    monkeypatch.setattr(unet3d, "temporal_attention", count("temporal", real_t))
    return calls


def _meta_call(cfg: UNetConfig, hw, added: bool):
    with torch.device("meta"), torch.no_grad():
        model = UNet3DConditionModel(cfg)
        added_cond = {"text_embeds": torch.empty(3, 1280), "time_ids": torch.empty(3, 6)}
        extra = {"added_cond": added_cond} if added else {}
        out = model(torch.empty(3, 16, *hw, 8), torch.zeros(3, dtype=torch.long),
                    torch.empty(3, 77, cfg.cross_attention_dim), 0, **extra)
    return model, out


def test_sd15_layout_and_dispatches_unchanged(monkeypatch):
    """The flagship UNet3D: the same 1206 state-dict keys and shapes as
    before the SDXL configuration, and the edit's 3-way call (16 frames of
    32 x 48 latents) dispatches A 10, B 36 and C 40 times, as the edit
    cell's plan counts."""
    calls = _dispatches(monkeypatch)
    model, out = _meta_call(UNetConfig(), (32, 48), added=False)
    layout = repr([(k, tuple(v.shape)) for k, v in model.state_dict().items()])
    assert hashlib.md5(layout.encode()).hexdigest() == "ba03032638d2807ae909ee898ace9fee"
    assert out.shape == (3, 16, 32, 48, 4)
    assert calls == {"flash": 10, "ff": 36, "temporal": 40}
    plan = unet3d_launches(ref_cfg(UNetConfig()), 3, 16, 32, 48)
    assert calls == {k: len(v) for k, v in plan.items()}


def test_sdxl_work_plan_counts_the_dispatches(monkeypatch):
    """The SDXL UNet3D's 3-way call at the cell's 16 frames of 96 x 96
    latents: A 70 times (every attn1 at S = 2304 and 576), B 85 (70
    spatial, 15 motion), C 30, as work/sdxl.py plans them."""
    calls = _dispatches(monkeypatch)
    cfg = sdxl_config()
    _meta_call(cfg, (96, 96), added=True)
    plan = unet3d_xl_launches(ref_cfg(cfg), 3, 16, 96, 96)
    assert calls == {k: len(v) for k, v in plan.items()} == {"flash": 70, "ff": 85, "temporal": 30}
    assert {len(set(w for w in plan["flash"]))} == {2}


def test_stacks_run_in_spans_named_by_level(tiny_unet):
    from insv2v_torch.utils import tracing

    model, _ = tiny_unet
    before = {n: tracing.count(n) for n in ("unet.stack.l1", "unet.stack.l2")}
    x = inputs(b=1)
    with torch.no_grad():
        model(x["sample"], x["t"], x["ctx"], 0, added_cond={"text_embeds": x["pooled"],
                                                             "time_ids": x["ids"]})
    # level 1: 2 down + 3 up stacks of 2; level 2: 2 down + mid + 3 up of 3
    assert {n: tracing.count(n) - before[n] for n in before} == {"unet.stack.l1": 5,
                                                                  "unet.stack.l2": 6}
    with pytest.raises(ValueError, match="added_cond"):
        model(x["sample"], x["t"], x["ctx"], 0)


def test_edit_cli_runs_the_sdxl_config(tmp_path, monkeypatch):
    """``apps/edit_video.py --config`` on configs/insv2v_sdxl.yaml cut to a
    tiny width: the factory builds the two-tower text encoder and the
    ``text_time`` UNet, the editor takes the config's VAE scale factor, and
    the edit runs through ``VideoEditor``."""
    import cv2
    import yaml

    from insv2v_torch.apps import edit_video

    cfg = load_config(os.path.join(REPO, "configs", "insv2v_sdxl.yaml"))
    cfg["unet"]["params"].update({k: list(v) if isinstance(v, tuple) else v
                                  for k, v in TINY.items()})
    cfg["vae"]["params"]["ddconfig"].update(ch=8, ch_mult=[1, 2, 2, 2], num_res_blocks=1)
    cfg["text_model"]["params"]["clip"].update(CLIP)
    cfg["text_model"]["params"]["openclip"].update(BIGG)
    path = tmp_path / "tiny_sdxl.yaml"
    path.write_text(yaml.safe_dump(cfg))
    video = str(tmp_path / "in.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 8, (32, 32))
    for i in range(6):
        vw.write(np.full((32, 32, 3), 40 * i, dtype=np.uint8))
    vw.release()
    made = []
    real = edit_video.make_editor
    monkeypatch.setattr(edit_video, "make_editor",
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    out = str(tmp_path / "out.gif")
    edit_video.main(["--video", video, "--prompt", "make it snowy", "--output", out,
                     "--config", str(path), "--allow-random-weights", "--device", "cpu",
                     "--image-size", "32", "--num-frames", "4", "--frames-in-batch", "4",
                     "--num-ref-frames", "0", "--scheduler", "ddim", "--steps", "2"])
    editor = made[0]
    assert isinstance(editor.text_encoder, DualTextEncoder)
    assert editor.unet.cfg.addition_embed_type == "text_time"
    assert editor.scale_factor == 0.13025
    assert os.path.getsize(out) > 0
