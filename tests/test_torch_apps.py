"""The port's remaining samplers, media and dataset helpers, CLIP scoring and
the three CLIs (edit, LOVEU-TGVE runner, LOVEU scorer) against the JAX
package, float32 on the CPU at tiny sizes; the CLIs run with ``--device
cpu`` on the tiny YAML of ``tests/test_apps.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.data import datasets as jdata
from insv2v_tpu.diffusion import samplers as jsamp
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_vision import ClipVisionConfig as JVisCfg
from insv2v_tpu.models.clip_vision import ClipVisionEncoder as JVis
from insv2v_tpu.models.clip_vision import preprocess_frames as jpreprocess
from insv2v_tpu.utils import clip_metrics as jclip
from insv2v_tpu.utils import media as jmedia
from insv2v_tpu.utils.convert import convert_clip_model_state_dict
from insv2v_torch.data import datasets as tdata
from insv2v_torch.diffusion import samplers as tsamp
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.clip_text import ClipTextConfig
from insv2v_torch.models.clip_vision import ClipVisionConfig, preprocess_frames
from insv2v_torch.utils import clip_metrics as tclip
from insv2v_torch.utils import media as tmedia
from insv2v_torch.utils.convert import torch_state_dict_from_flax
from test_apps import write_tiny_config
from test_torch_pipeline import TinyTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_step_noises(rng, steps, shape):
    """The normals the JAX samplers' scans draw: split, then normal."""
    out, key = [], rng
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(nkey, shape, dtype=jnp.float32)))
    return out


JS, TS = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()


# --- the remaining samplers ---------------------------------------------------


@pytest.mark.parametrize("mode", ["cfg", "null_embeddings", "no_cfg"])
def test_sample_plain_matches_jax(mode):
    """DDPM 3 steps with a linear probe UNet, the JAX run's noise injected:
    single CFG with a fixed uncond, with per-step null embeddings, and
    without CFG. Tolerance 1e-5."""
    def jprobe(params, x, t, ctx, vsi):
        return 0.5 * x + jnp.mean(ctx, axis=(1, 2))[:, None, None, None, None] + 1e-3 * t[:, None, None, None, None]

    def tprobe(x, t, ctx, vsi):
        return 0.5 * x + ctx.mean(dim=(1, 2))[:, None, None, None, None] + 1e-3 * t[:, None, None, None, None]

    rs = np.random.RandomState(0)
    lat = rs.randn(1, 2, 4, 4, 2).astype(np.float32)
    ctx, un = rs.randn(1, 3, 5).astype(np.float32), rs.randn(1, 3, 5).astype(np.float32)
    nulls = rs.randn(3, 1, 3, 5).astype(np.float32)
    kw = {"cfg": dict(uncond_context=un), "null_embeddings": dict(null_embeddings=nulls),
          "no_cfg": dict()}[mode]
    scale = 1.0 if mode == "no_cfg" else 4.0
    jt = jsched.make_sampler_tables(JS, 3, kind="ddpm")
    want = jsamp.sample_plain(jprobe, None, jt, jnp.asarray(lat), jnp.asarray(ctx),
                              guidance_scale=scale, return_all=True,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    noises = jax_step_noises(jax.random.PRNGKey(0), 3, lat.shape)
    got = tsamp.sample_plain(tprobe, tsched.make_sampler_tables(TS, 3, kind="ddpm"), np_t(lat),
                             np_t(ctx), guidance_scale=scale, return_all=True,
                             step_noise=lambda i, s: torch.tensor(noises[i]),
                             **{k: np_t(v) for k, v in kw.items()})
    for key in ("latent", "pred_x0", "all_latent", "all_pred"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["ddim", "ddpm"])
def test_sample_edit_ref_image_matches_jax(kind):
    """The 4-way CFG over [latent | img | edit] with a linear probe that
    weighs each channel group apart, so every lever shows. Tolerance 1e-5."""
    def jprobe(params, x, t, ctx, vsi):
        lat, img, edit = jnp.split(x, 3, axis=-1)
        return lat + 0.1 * img + 0.2 * edit + jnp.mean(ctx, axis=(1, 2))[:, None, None, None]

    def tprobe(x, t, ctx, vsi):
        lat, img, edit = x.chunk(3, dim=-1)
        return lat + 0.1 * img + 0.2 * edit + ctx.mean(dim=(1, 2))[:, None, None, None]

    rs = np.random.RandomState(1)
    lat, img, edit = (rs.randn(2, 4, 4, 2).astype(np.float32) for _ in range(3))
    tc, tu = rs.randn(2, 3, 5).astype(np.float32), rs.randn(2, 3, 5).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    kw = dict(text_cfg=3.0, img_cfg=1.5, edit_cfg=2.0)
    want = jsamp.sample_edit_ref_image(
        jprobe, None, jsched.make_sampler_tables(JS, 3, kind=kind), jnp.asarray(lat),
        jnp.asarray(img), jnp.asarray(edit), jnp.asarray(tc), jnp.asarray(tu), rng, **kw)
    noises = jax_step_noises(rng, 3, lat.shape)
    got = tsamp.sample_edit_ref_image(
        tprobe, tsched.make_sampler_tables(TS, 3, kind=kind), np_t(lat), np_t(img),
        np_t(edit), np_t(tc), np_t(tu), step_noise=lambda i, s: torch.tensor(noises[i]), **kw)
    for key in ("latent", "pred_x0"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)


# --- media --------------------------------------------------------------------


def make_video(path, n=10, hw=(40, 48), fps=8, seed=0):
    import cv2

    h, w = hw
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        fr = np.stack([(xx * 5 + i * 9) % 256, (yy * 6) % 256, (xx + yy + i * 20) % 256], -1)
        vw.write(fr.astype(np.uint8))
    vw.release()
    return str(path)


def test_uint8_conversions_and_concat_match_jax():
    x = np.random.RandomState(2).uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmedia.to_uint8(x), jmedia.to_uint8(x))
    u = jmedia.to_uint8(x)
    np.testing.assert_array_equal(tmedia.from_uint8(u), jmedia.from_uint8(u))
    np.testing.assert_array_equal(tmedia.concat_videos([x, -x]), jmedia.concat_videos([x, -x]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gif_round_trip_matches_jax(tmp_path, writer):
    """A GIF written by either package decodes to the same frames through
    both loaders; the port's own round trip keeps shape, frame count and
    (for the few colours of this clip) the pixels."""
    yy, xx = np.mgrid[0:12, 0:20]
    frames = np.stack([np.stack([(xx // 5) * 0.5 - 1, (yy // 6) * 0.5 - 0.5, np.full_like(xx, k) * 0.5 - 1], -1)
                       for k in range(4)]).astype(np.float32)
    path = str(tmp_path / "sub" / "a.gif")
    (tmedia.save_gif if writer == "port" else jmedia.save_gif)(frames, path)
    got, want = tmedia.load_gif(path), jmedia.load_gif(path)
    assert got.shape == (4, 12, 20, 3)
    np.testing.assert_array_equal(got, want)
    if writer == "port":
        np.testing.assert_allclose(got, tmedia.from_uint8(tmedia.to_uint8(frames)), atol=1e-6)


def test_video_frames_resize_and_frame_dumps_match_jax(tmp_path):
    mp4 = make_video(tmp_path / "v.mp4")
    for kw in (dict(), dict(num_frames=3, start_frame=2, frame_skip=2, height=20, width=30)):
        np.testing.assert_array_equal(tmedia.read_video_frames(mp4, **kw),
                                      jmedia.read_video_frames(mp4, **kw))
    fr = (np.random.RandomState(3).rand(40, 48, 3) * 255).astype(np.uint8)
    for keep in (True, False):
        np.testing.assert_array_equal(tmedia.resize_frame(fr, 21, 17, keep),
                                      jmedia.resize_frame(fr, 21, 17, keep))
    x = tmedia.from_uint8(fr[None].repeat(2, 0))
    ours = tmedia.save_frames(x, str(tmp_path / "a"), "e")
    theirs = jmedia.save_frames(x, str(tmp_path / "b"), "e")
    assert [os.path.basename(p) for p in ours] == ["e00000.jpg", "e00001.jpg"]
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


# --- datasets -----------------------------------------------------------------


def make_loveu(root, names=("gold-fish", "bear")):
    """A LOVEU-TGVE layout: one DAVIS and one Videvo video and the CSV with
    its header and section rows."""
    (root / "DAVIS_480p" / "480p_videos").mkdir(parents=True)
    (root / "videvo_480p" / "480p_videos").mkdir(parents=True)
    make_video(root / "DAVIS_480p" / "480p_videos" / f"{names[0]}.mp4", n=8, hw=(48, 48))
    make_video(root / "videvo_480p" / "480p_videos" / f"{names[1]}.mp4", n=6, hw=(36, 52),
               fps=24, seed=1)
    with open(root / "LOVEU-TGVE-2023_Dataset.csv", "w") as f:
        f.write("Video name,Original,Style,Object,Background,Multiple\n")
        f.write("DAVIS Videos:,,,,,\n")
        f.write(f"{names[0]},a goldfish,goldfish in ink,a shark,goldfish in a pond,sharks in a pond\n")
        f.write(",,,,,\n")
        f.write("Videvo Videos:,,,,,\n")
        f.write(f"{names[1]},a bear,styled bear,a panda,bear on the moon,panda on the moon\n")
    return str(root)


def test_loveu_dataset_matches_jax(tmp_path):
    root = make_loveu(tmp_path)
    ours = tdata.LoveuTgveVideoDataset(root, image_size=(24, 32))
    theirs = jdata.LoveuTgveVideoDataset(root, image_size=(24, 32))
    assert ours.video_names() == theirs.video_names() == ["gold-fish", "bear"]
    assert ours.EDIT_KEYS == theirs.EDIT_KEYS
    for idx in ("bear", 0):
        a, b = ours[idx], theirs[idx]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert ours["bear"]["frames"].shape == (6, 24, 32, 3)


@pytest.mark.parametrize("n,second", [(30, 0), (30, 1), (12, 0)])
def test_single_video_dataset_matches_jax(tmp_path, n, second):
    """fps resampling (24 -> 8: every third frame), aspect-preserving resize
    and crop, and the padding of a short clip."""
    mp4 = make_video(tmp_path / "v.mp4", n=n, fps=24)
    kw = dict(sampling_fps=8, num_frames=6, output_size=(20, 28))
    ours, theirs = tdata.SingleVideoDataset(mp4, "clip", **kw), jdata.SingleVideoDataset(mp4, "clip", **kw)
    assert len(ours) == len(theirs)
    a, b = ours[second], theirs[second]
    np.testing.assert_array_equal(a["frames"], b["frames"])
    assert a["text"] == b["text"] == "clip" and a["frames"].shape == (6, 20, 28, 3)


def test_prompt_dict_is_the_jax_packages_copy():
    read = lambda *p: open(os.path.join(REPO, *p), "rb").read()
    assert read("insv2v_torch", "data", "loveu_tgve_edit_prompt_dict.json") == \
        read("insv2v_tpu", "data", "loveu_tgve_edit_prompt_dict.json")


# --- CLIP scoring -------------------------------------------------------------

TEXT_KW = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)
VIS_KW = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, image_size=28,
              patch_size=14, projection_dim=8)


def tiny_clip():
    """Port CLIP towers with seeded weights (LayerNorm affines and the class
    token made non-trivial) and the same weights as the JAX scorer's tree."""
    models = tclip.clip_models(ClipTextConfig(**TEXT_KW), ClipVisionConfig(**VIS_KW), seed=1)
    with torch.no_grad():
        for m in models.values():
            for name, p in m.named_parameters():
                if "norm" in name:
                    p.add_(0.1 * torch.randn_like(p))
    sd = {k: v for m in models.values() for k, v in m.state_dict().items()}
    return models, sd, convert_clip_model_state_dict(sd)


def test_clip_model_state_dict_round_trips_through_flax():
    models, sd, params = tiny_clip()
    back = torch_state_dict_from_flax(params, "clip_model")
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    rebuilt = tclip.clip_models(ClipTextConfig(**TEXT_KW), ClipVisionConfig(**VIS_KW),
                                state_dict=back, seed=7)
    for name, m in rebuilt.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, models[name].state_dict()[k]), k
    with pytest.raises(ValueError, match="no tower"):
        tclip.clip_models(ClipTextConfig(**TEXT_KW), ClipVisionConfig(**VIS_KW),
                          state_dict=dict(back, logit_scale=torch.zeros(())))


def test_clip_vision_tower_matches_flax():
    """Preprocessing (bilinear to the tower's size, CLIP mean and std) and
    the vision tower's pooled output. Tolerance 1e-4."""
    models, _, params = tiny_clip()
    rs = np.random.RandomState(4)
    frames = np.clip(rs.randn(3, 20, 36, 3) * 0.5, -1, 1).astype(np.float32)
    x = preprocess_frames(np_t(frames), 28)
    jx = jpreprocess(jnp.asarray(frames), 28)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
    with torch.no_grad():
        got = models["vision"](x).numpy()
    want = JVis(JVisCfg(**VIS_KW)).apply({"params": params["vision"]}, jx)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_clip_similarity_matches_jax():
    """The four scores per frame (two frame sets, two captions), and each
    feature. Tolerance 1e-4."""
    models, _, params = tiny_clip()
    tok = TinyTokenizer()
    ours = tclip.ClipSimilarity(models, tokenizer=tok, device="cpu")
    theirs = jclip.ClipSimilarity(params, tokenizer=tok, text_cfg=JClipCfg(**TEXT_KW),
                                  vision_cfg=JVisCfg(**VIS_KW))
    rs = np.random.RandomState(5)
    f0, f1 = (np.clip(rs.randn(4, 24, 24, 3) * 0.5, -1, 1).astype(np.float32) for _ in range(2))
    texts = (["a bear in the woods"], ["a panda on the moon"])
    got, want = ours(f0, f1, *texts), theirs(f0, f1, *texts)
    assert set(got) == set(want) == {"sim_0", "sim_1", "sim_direction", "sim_image"}
    for k in got:
        assert got[k].shape == (4,)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours.text_features(texts[1]).numpy(),
                               np.asarray(theirs.text_features(texts[1])), atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tclip.ClipSimilarity(models, tokenizer=tok)


# --- the CLIs -----------------------------------------------------------------


@pytest.fixture
def tiny_cli(tmp_path, monkeypatch):
    """The tiny YAML of tests/test_apps.py, with a one-layer CLIP text model
    at its 768 width and a tiny CLIP image tower standing in for ViT-L/14."""
    monkeypatch.setattr(ClipTextConfig, "vit_l_14", classmethod(
        lambda cls: cls(vocab_size=49408, hidden_size=768, num_layers=1, num_heads=4,
                        intermediate_size=32)))
    monkeypatch.setattr(ClipVisionConfig, "vit_l_14", classmethod(
        lambda cls: cls(**VIS_KW)))
    monkeypatch.delenv("INSV2V_RAFT_WEIGHTS", raising=False)
    return write_tiny_config(tmp_path)


def test_edit_cli_with_optical_flow(tmp_path, tiny_cli):
    """6 frames at 32x32 in windows of 4 with 2 refs: the second window
    takes Farneback flows; the GIF holds input | edit."""
    from insv2v_torch.apps import edit_video

    mp4 = make_video(tmp_path / "in.mp4", n=8, hw=(48, 48))
    out = str(tmp_path / "out.gif")
    argv = ["--video", mp4, "--prompt", "make it snowy", "--output", out, "--config", tiny_cli,
            "--allow-random-weights", "--image-size", "32", "--num-frames", "6",
            "--frames-in-batch", "4", "--num-ref-frames", "2", "--steps", "2",
            "--with-optical-flow", "--flow-estimator", "farneback"]
    edit_video.main(argv + ["--device", "cpu"])
    gif = tmedia.load_gif(out)
    assert gif.shape == (6, 32, 64, 3) and np.isfinite(gif).all()
    with pytest.raises(SystemExit):  # no checkpoint and no --allow-random-weights
        edit_video.main([a for a in argv if a != "--allow-random-weights"] + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            edit_video.main(argv)


def test_loveu_runner_resumes_and_scores(tmp_path, tiny_cli):
    """The runner over one video of a LOVEU layout: its four edit types as
    one batched chain with the packaged edit instructions, then a resumed
    run that does no work, then the CSV captions (``--prompt-source
    original``) in serial chains; the scorer over the first run's GIFs."""
    from insv2v_torch.apps import run_loveu_tgve, score_loveu

    root = make_loveu(tmp_path / "loveu")
    base = ["--config-path", tiny_cli, "--data-dir", root, "--allow-random-weights",
            "--image-size", "32", "--num-frames", "4", "--steps", "2", "--frames-in-batch", "4",
            "--num-ref-frames", "2", "--limit-videos", "1", "--device", "cpu"]
    out = str(tmp_path / "out")
    metrics = run_loveu_tgve.main(base + ["--output-dir", out, "--batch-edits", "4"])
    gifs = sorted(f for f in os.listdir(out) if f.endswith(".gif"))
    assert len(gifs) == 4 and metrics["videos"] == 4 and metrics["frames"] == 16
    assert metrics["frames_per_sec"] > 0 and "window_0" in metrics["stage_seconds"]
    assert metrics["output_seconds"] > 0
    used = json.load(open(os.path.join(out, "prompts_used.json")))
    tag = "gold-fish-style-tcfg7.5-vcfg1.8-f4-s32"
    assert used[tag] == "make the style impressionist"
    assert len(os.listdir(os.path.join(out, tag))) == 4
    again = run_loveu_tgve.main(base + ["--output-dir", out])
    assert again["videos"] == 0
    assert json.load(open(os.path.join(out, "throughput.json")))["videos"] == 0
    assert json.load(open(os.path.join(out, "prompts_used.json"))) == used

    orig = str(tmp_path / "orig")
    run_loveu_tgve.main(base + ["--output-dir", orig, "--prompt-source", "original",
                                "--num-shards", "2", "--shard-index", "0"])
    shard = json.load(open(os.path.join(orig, "prompts_used.shard00.json")))
    assert shard[tag] == "goldfish in ink" and len(shard) == 4

    summary = score_loveu.main(["--outputs", out, "--data-dir", root,
                                "--allow-random-weights", "--frames-per-video", "2",
                                "--device", "cpu"])
    assert summary["count"] == 4
    saved = json.load(open(os.path.join(out, "clip_scores.json")))
    for k in ("sim_0", "sim_1", "sim_direction", "sim_image"):
        assert np.isfinite(saved[k]) and all(np.isfinite(r[k]) for r in saved["records"])
    with pytest.raises(SystemExit):
        score_loveu.main(["--outputs", out, "--data-dir", root, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_loveu_tgve.main(base[:-2] + ["--output-dir", str(tmp_path / "gpu")])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            score_loveu.main(["--outputs", out, "--data-dir", root, "--allow-random-weights"])
