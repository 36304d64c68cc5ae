"""The port's VideoEditor end to end against the JAX package's, on tiny
models with one weight set, plus the port's isolation from JAX: it imports
no jax, names no file of the JAX package, and its entry points refuse to
run on a machine without a GPU unless asked for the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.diffusion.pipeline import VideoEditor as JEditor
from insv2v_tpu.diffusion.samplers import split_windows
from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_text import ClipTextEncoder as JClip
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.models.vae import AutoencoderKL as JVae
from insv2v_tpu.models.vae import VaeConfig as JVaeCfg
from insv2v_tpu.text import tokenizer as jtok
from insv2v_tpu.utils.convert import (convert_clip_text_state_dict,
                                      convert_unet3d_state_dict, convert_vae_state_dict)
from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.text import tokenizer as ttok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4,
              resolution=32)
CLIP_KW = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)


class TinyTokenizer(ttok.HashTokenizer):
    vocab_size = 100
    sot_id = 98
    eot_id = 99


def tiny_models(seed=0):
    """Port modules with seeded torch weights (live motion modules) and the
    same weights as Flax trees, without a slow Flax init."""
    torch.manual_seed(seed)
    unet = UNet3DConditionModel(UNetConfig.tiny())
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if "temporal_transformer.proj_out" in name:
                p.copy_(torch.randn_like(p) * 0.3)
    vae, clip = AutoencoderKL(VaeConfig(**VAE_KW)), ClipTextEncoder(ClipTextConfig(**CLIP_KW))
    params = {"unet": convert_unet3d_state_dict(unet.state_dict()),
              "vae": convert_vae_state_dict(vae.state_dict()),
              "text": convert_clip_text_state_dict(clip.state_dict())}
    return (unet, vae, clip), params


def jax_editor_normals(seed, frames, fpw, nref, latent_hw, ch=4, chunk=16):
    """Replays VideoEditor.__call__'s key splits: the JAX run's normals by kind."""
    h, w = latent_hw
    rng = jax.random.PRNGKey(seed)
    rng, enc_rng, lat_rng = jax.random.split(rng, 3)
    out = {"encode": [], "init": [], "window": []}
    for i in range(0, frames, chunk):
        enc_rng, sub = jax.random.split(enc_rng)
        n = min(chunk, frames - i)
        out["encode"].append(jax.random.normal(sub, (n, h, w, ch), dtype=jnp.float32))
    windows = split_windows(frames, fpw, nref)
    out["init"].append(jax.random.normal(lat_rng, (1, windows[0].num_frames, h, w, ch),
                                         dtype=jnp.float32))
    rng, _ = jax.random.split(rng)
    for spec in windows[1:]:
        rng, nrng, _ = jax.random.split(rng, 3)
        out["window"].append(jax.random.normal(
            nrng, (1, spec.num_frames - spec.num_ref, h, w, ch), dtype=jnp.float32))
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


class ReplayNoise:
    """The port's noise seam fed with the JAX run's normals, in order."""

    def __init__(self, normals):
        self.queues = {k: list(v) for k, v in normals.items()}

    def __call__(self, kind, shape):
        a = self.queues[kind].pop(0)
        assert tuple(a.shape) == tuple(shape), (kind, a.shape, shape)
        return torch.tensor(a)


def test_two_window_edit_matches_jax_editor():
    """10 frames at 32x32 in 6-frame windows with 2 refs (2 windows, ref
    anchoring), DDIM 3 steps, float32 on both sides, the same tokenizer
    callable and normals. The 16x16 latent sends the UNet's level-0
    self-attention and the VAE mid-block attention through the flash
    dispatch. Tolerance 2e-4 on frames in [-1, 1]: float32 through VAE
    encode, 6 UNet calls and VAE decode."""
    (unet, vae, clip), params = tiny_models()
    tok = TinyTokenizer()
    rs = np.random.RandomState(0)
    frames = np.clip(rs.randn(10, 32, 32, 3) * 0.3, -1, 1).astype(np.float32)
    kw = dict(frames_per_window=6, num_ref_frames=2, noise_correct_step=0.5, seed=3)
    jed = JEditor(JUNet(cfg=JUNetCfg.tiny()), JVae(cfg=JVaeCfg(**VAE_KW)),
                  JClip(JClipCfg(**CLIP_KW)), params, tokenizer=tok, scheduler="ddim",
                  num_steps=3, params_dtype=None)
    want = jed(frames, "make it snowy", **kw)
    ted = VideoEditor(unet, vae, clip, tokenizer=tok, scheduler="ddim", num_steps=3,
                      device="cpu", dtype=torch.float32)
    normals = jax_editor_normals(3, 10, 6, 2, (16, 16))
    got = ted(frames, "make it snowy", noise=ReplayNoise(normals), **kw)
    assert got.shape == frames.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)


def test_prompt_list_shares_the_chain():
    """A list of prompts runs one chain whose element k equals the solo call."""
    (unet, vae, clip), _ = tiny_models(1)
    ted = VideoEditor(unet, vae, clip, tokenizer=TinyTokenizer(), scheduler="ddpm",
                      num_steps=2, device="cpu", dtype=torch.float32)
    frames = np.clip(np.random.RandomState(1).randn(8, 32, 32, 3) * 0.3, -1, 1).astype(np.float32)
    kw = dict(frames_per_window=6, num_ref_frames=2, seed=5)
    both = ted(frames, ["red car", "van gogh style"], **kw)
    solo = ted(frames, "van gogh style", **kw)
    assert both.shape == (2,) + frames.shape
    np.testing.assert_allclose(both[1], solo, atol=1e-5)


@pytest.mark.parametrize("text", ["make it snowy", "The CAT!  at 42 times", ""])
def test_hash_tokenizer_ids_match_jax(text):
    np.testing.assert_array_equal(ttok.HashTokenizer()([text]), jtok.HashTokenizer()([text]))


def test_bpe_tokenizer_ids_match_jax(tmp_path):
    btu = ttok.bytes_to_unicode()
    vocab = {}
    for tok in [btu[b] for b in range(256)]:
        vocab[tok] = len(vocab)
        vocab[tok + "</w>"] = len(vocab)
    merges = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    (tmp_path / "v.json").write_text(json.dumps(vocab))
    (tmp_path / "m.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    paths = (str(tmp_path / "v.json"), str(tmp_path / "m.txt"))
    texts = ["the cat", "The CAT & the dog, 42!"]
    np.testing.assert_array_equal(ttok.ClipTokenizer.from_files(*paths)(texts),
                                  jtok.ClipTokenizer.from_files(*paths)(texts))


def test_import_leaves_jax_out():
    code = ("import pkgutil, sys, importlib, insv2v_torch\n"
            "for m in pkgutil.walk_packages(insv2v_torch.__path__, 'insv2v_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'insv2v_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_no_port_file_names_the_jax_package():
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "insv2v_torch")):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            with open(os.path.join(root, f), errors="replace") as fh:
                if "insv2v_tpu" in fh.read():
                    hits.append(f)
    assert not hits


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from insv2v_torch.utils.factory import build_models

    (unet, vae, clip), _ = tiny_models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoEditor(unet, vae, clip, tokenizer=TinyTokenizer())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models()


def test_motion_compensation_is_not_ported_yet():
    (unet, vae, clip), _ = tiny_models()
    ted = VideoEditor(unet, vae, clip, tokenizer=TinyTokenizer(), device="cpu",
                      dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ted(np.zeros((2, 32, 32, 3), np.float32), "x", use_motion_compensation=True)
