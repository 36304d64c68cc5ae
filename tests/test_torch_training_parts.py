"""The parts of the port's training slice around the trainer: the
optimizers (training.quantized_adam, torch Adam) against optax and the
JAX adam8bit, add_noise, the checkpoints (utils.checkpoint) against the
JAX loader, validation sampling against the JAX validation function, the
datasets against the JAX package's, and the training CLI (apps.train), at
fixture size in float32 on the CPU. Tolerances are stated per test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from insv2v_tpu.data import datasets as jdata
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_text import ClipTextEncoder as JClip
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.models.vae import AutoencoderKL as JVae
from insv2v_tpu.models.vae import VaeConfig as JVaeCfg
from insv2v_tpu.parallel.mesh import make_mesh
from insv2v_tpu.training import quantized_adam as jqa
from insv2v_tpu.training import trainer as jtrainer
from insv2v_tpu.training.validation import make_validation_fn as j_make_validation_fn
from insv2v_tpu.utils.checkpoint import load_pipeline_params as j_load_pipeline_params
from insv2v_tpu.utils.convert import (convert_clip_text_state_dict,
                                      convert_unet3d_state_dict, convert_vae_state_dict)
from insv2v_torch.data import datasets as tdata
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.training import quantized_adam as tqa
from insv2v_torch.training import trainer as ttrainer
from insv2v_torch.training.validation import make_validation_fn
from insv2v_torch.utils import checkpoint as tckpt
from insv2v_torch.utils.convert import torch_state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=49408, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)
ACCUM, MICRO, FRAMES, SIZE = 2, 2, 2, 16


@pytest.fixture(scope="module")
def jax_setup():
    """The tiny models of tests/test_trainer.py and one weight set, made by
    the port (a Flax init of the tiny UNet takes a minute here) and carried
    to Flax by the JAX package's converters. The motion modules' zero
    proj_out is made random, or every motion gradient but proj_out's would
    be zero and the check would say little."""
    torch.manual_seed(0)
    unet = UNet3DConditionModel(UNetConfig.tiny(in_channels=8, out_channels=4))
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if "temporal_transformer.proj_out" in name:
                p.normal_(0.0, 0.3)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    unet_p = np_tree(convert_unet3d_state_dict(unet.state_dict()))
    vae_p = np_tree(convert_vae_state_dict(AutoencoderKL(VaeConfig(**VAE_KW)).state_dict()))
    clip_p = np_tree(convert_clip_text_state_dict(
        ClipTextEncoder(ClipTextConfig(**CLIP_KW)).state_dict()))
    trainer = jtrainer.Trainer(JUNet(cfg=JUNetCfg.tiny(in_channels=8, out_channels=4)),
                               JVae(cfg=JVaeCfg(**VAE_KW)), JClip(JClipCfg(**CLIP_KW)),
                               jtrainer.TrainConfig(lr=1e-3, accumulate_grad_batches=ACCUM),
                               mesh=make_mesh(jax.devices()[:1]))
    return trainer, unet_p, vae_p, clip_p


def port_models(unet_p, vae_p, clip_p):
    unet = UNet3DConditionModel(UNetConfig.tiny(in_channels=8, out_channels=4))
    unet.load_state_dict(torch_state_dict_from_flax(unet_p, "unet3d"))
    vae = AutoencoderKL(VaeConfig(**VAE_KW))
    vae.load_state_dict(torch_state_dict_from_flax(vae_p, "vae"))
    text = ClipTextEncoder(ClipTextConfig(**CLIP_KW))
    text.load_state_dict(torch_state_dict_from_flax(clip_p, "clip_text"))
    return unet, vae, text


def make_batch(n=ACCUM * MICRO, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "input_video": (rs.randn(n, FRAMES, SIZE, SIZE, 3) * 0.3).astype(np.float32),
        "edited_video": (rs.randn(n, FRAMES, SIZE, SIZE, 3) * 0.3).astype(np.float32),
        "prompt_ids": rs.randint(0, 50, (n, 77)).astype(np.int32),
    }


LATENT = (FRAMES, SIZE // 2, SIZE // 2, 4)  # one VAE downsample


def port_trainer(jax_setup, **cfg):
    _, unet_p, vae_p, clip_p = jax_setup
    unet, vae, text = port_models(unet_p, vae_p, clip_p)
    cfg = dict(dict(lr=1e-3, accumulate_grad_batches=ACCUM), **cfg)
    trainer = ttrainer.Trainer(unet, vae, text, ttrainer.TrainConfig(**cfg))
    return trainer, trainer.create_state()


# --- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "adam8bit"])
def test_train_state_round_trip(jax_setup, tmp_path, kind):
    """Save after one step, restore into a fresh state: the same masters,
    step and optimizer state, and the next step gives the same numbers."""
    batch, gen = make_batch(seed=3), lambda: torch.Generator().manual_seed(5)
    trainer, state = port_trainer(jax_setup, optimizer=kind)
    trainer.train_step(state, batch, gen())
    path = tckpt.save_train_state(state, str(tmp_path))
    assert os.path.basename(path) == "step_00000001.pt"
    trainer2, state2 = port_trainer(jax_setup, optimizer=kind)
    tckpt.restore_train_state(str(tmp_path), state2)
    trainer2.push_params(state2)
    assert state2.step == 1
    for k in state.params:
        torch.testing.assert_close(state2.params[k], state.params[k], rtol=0, atol=0)
    _, m1 = trainer.train_step(state, batch, gen())
    _, m2 = trainer2.train_step(state2, batch, gen())
    assert m1 == m2
    for k in state.params:
        torch.testing.assert_close(state2.params[k], state.params[k], rtol=0, atol=0)


def test_fused_checkpoint_loads_like_the_jax_loader(jax_setup, tmp_path):
    """A fused insv2v.pth in the reference's layout (DeepSpeed prefix, the
    text model under its FrozenCLIPEmbedder's ``transformer.``, a VAE
    ``loss.`` tree and a ``pos_encoder.pe`` table to drop) loads into the
    port's modules with the same values the JAX loader gives its trees."""
    _, unet_p, vae_p, clip_p = jax_setup
    unet, vae, text = port_models(unet_p, vae_p, clip_p)
    fused = {}
    for prefix, m in (("unet.", unet), ("vae.", vae), ("text_model.transformer.", text)):
        fused.update({"_forward_module." + prefix + k: v for k, v in m.state_dict().items()})
    pe_key = ("_forward_module.unet.down_blocks.0.motion_modules.0.temporal_transformer."
              "transformer_blocks.0.attention_blocks.0.pos_encoder.pe")
    fused[pe_key] = torch.zeros(1, 8, 8)
    fused["_forward_module.vae.loss.logvar"] = torch.zeros(())
    path = str(tmp_path / "insv2v.pth")
    torch.save({"state_dict": fused}, path)
    sds = tckpt.load_pipeline_state_dicts(fused_ckpt=path)
    fresh = dict(zip(("unet", "vae", "text_model"), port_models(
        *(jax.tree_util.tree_map(np.zeros_like, t) for t in (unet_p, vae_p, clip_p)))))
    tckpt.load_into(fresh, sds)
    jtrees = j_load_pipeline_params(fused_ckpt=path)
    for part, kind, module in (("unet", "unet3d", "unet"), ("vae", "vae", "vae"),
                               ("text", "clip_text", "text_model")):
        want = torch_state_dict_from_flax(jtrees[part], kind)
        got = fresh[module].state_dict()
        assert set(got) == set(want), part
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tckpt.load_into(fresh, {"vae": {"not.a.key": torch.zeros(1)}})


# --- the optimizers ------------------------------------------------------------

def _opt_problem():
    rs = np.random.RandomState(0)
    params = {"big": rs.randn(5000).astype(np.float32), "mat": rs.randn(70, 80).astype(np.float32),
              "small": rs.randn(30).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 10.0 ** rs.uniform(-4, 0, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adam", "adam8bit"])
def test_optimizer_matches_jax_over_three_steps(kind):
    """torch.optim.Adam against optax.adam, Adam8bit against the JAX
    adam8bit (two int8-quantized tensors, one of f32 moments): the params
    after each of 3 steps to 1e-6 absolute for Adam (lr 1e-2) and 1e-5 for
    Adam8bit (float32 log and exp of the two libraries differ in the last
    bit, which can move an int8 code by one step, ~3.6 % of that moment
    entry)."""
    params, grads = _opt_problem()
    cfg = ttrainer.TrainConfig(lr=1e-2, optimizer=kind)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = ttrainer.make_optimizer(cfg, list(tparams.values()))
    tx = optax.adam(1e-2) if kind == "adam" else jqa.adam8bit(1e-2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       atol=1e-6 if kind == "adam" else 1e-5, err_msg=k)


@pytest.mark.parametrize("signed", [True, False])
def test_quantize_blockwise_codes_match_jax(signed):
    """The same int8 codes and scales as the JAX quantizer on values across
    six decades (a ragged last block), and the same dequantized values."""
    rs = np.random.RandomState(1)
    x = (rs.randn(1000) * 10.0 ** rs.uniform(-6, 0, 1000)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    codes, scale = tqa.quantize_blockwise(torch.from_numpy(x), signed=signed)
    jcodes, jscale = jqa.quantize_blockwise(jnp.asarray(x), signed=signed)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = tqa.dequantize_blockwise(codes, scale, x.shape, signed=signed)
    jback = jqa.dequantize_blockwise(jcodes, jscale, x.shape, signed=signed)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6)


# --- schedules ------------------------------------------------------------------

def test_add_noise_and_pred_x0_match_jax():
    rs = np.random.RandomState(2)
    x0, eps = rs.randn(3, 2, 4, 4, 4).astype(np.float32), rs.randn(3, 2, 4, 4, 4).astype(np.float32)
    t = np.array([0, 500, 999])
    js, ts = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()
    want = jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
    got = tsched.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    back = tsched.pred_x0_from_eps(ts, got, torch.from_numpy(eps), torch.from_numpy(t))
    jback = jsched.pred_x0_from_eps(js, want, jnp.asarray(eps), jnp.asarray(t))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-5, atol=1e-5)


# --- validation ------------------------------------------------------------------

def test_validation_sampling_matches_jax(jax_setup):
    """A 3-step DDIM validation edit with the JAX run's posterior normals
    and initial latent: decoded frames and the x0-hat trajectory to 1e-4."""
    jtrainer_, unet_p, vae_p, clip_p = jax_setup
    state = jtrainer_.create_state(unet_p, vae_p, clip_p)
    vb = {k: v[:1] for k, v in make_batch(seed=4).items()}
    rng = jax.random.PRNGKey(9)
    want = j_make_validation_fn(jtrainer_, num_steps=3)(
        state, jax.tree_util.tree_map(jnp.asarray, vb), rng)
    r_enc, r_lat, _ = jax.random.split(rng, 3)
    draws = {"enc": np.array(jax.random.normal(r_enc, (FRAMES,) + LATENT[1:], jnp.float32)),
             "latent": np.array(jax.random.normal(r_lat, (1,) + LATENT, jnp.float32))}
    trainer, _ = port_trainer(jax_setup)
    got = make_validation_fn(trainer, num_steps=3)(vb, draws=draws)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), atol=1e-4)
    np.testing.assert_allclose(got["trajectory"].numpy(), np.asarray(want["trajectory"]),
                               atol=1e-4)


# --- datasets and the CLI ------------------------------------------------------------

def make_ptp_data(root, n_samples=2, size=SIZE):
    import cv2

    rs = np.random.RandomState(0)
    for s in range(n_samples):
        d = root / f"sample_{s:03d}"
        (d / "image").mkdir(parents=True)
        for which in (0, 1):
            for i in range(16):
                cv2.imwrite(str(d / "image" / f"1_{which}_{i:04d}.jpg"),
                            (rs.rand(size, size, 3) * 255).astype(np.uint8))
        with open(d / "metadata.jsonl", "w") as f:
            f.write(json.dumps({"seed": 1, "sim_0": 0.5, "sim_1": 0.5,
                                "sim_dir": 0.5, "sim_image": 0.9}) + "\n")
        with open(d / "prompt.json", "w") as f:
            json.dump({"input": "a", "output": "b", "edit": "c"}, f)
    return str(root)


@pytest.mark.parametrize("cls", ["VideoPromptToPromptDataset", "VideoPromptToPromptMotionAug"])
def test_datasets_match_jax(tmp_path, cls):
    """The same folders and RandomState seeds give the same arrays (the
    augmentation forced on: translation and zoom every time)."""
    root = make_ptp_data(tmp_path / "ptp")
    kw = dict(num_frames=4)
    if cls.endswith("MotionAug"):
        kw.update(translation_ratio=1.0, zoom_ratio=1.0)
    ours = getattr(tdata, cls)([root], rng=np.random.RandomState(4), **kw)
    theirs = getattr(jdata, cls)([root], rng=np.random.RandomState(4), **kw)
    assert len(ours) == len(theirs) == 2
    for i in (0, 1, 1):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


TINY_YAML = """
expt_dir: {tmp}/experiments
expt_name: tiny
trainer:
  accumulate_grad_batches: 2
  micro_batch_size: 1
  lr: 1.0e-3
  checkpoint_every: 2
  val_every: 2
diffusion:
  ddim_sampling_steps: 2
unet:
  params:
    in_channels: 8
    out_channels: 4
    attention_head_dim: 2
    block_out_channels: [8, 16, 16, 16]
    cross_attention_dim: 32
    norm_num_groups: 4
    motion_module_kwargs:
      num_attention_heads: 2
      temporal_position_encoding_max_len: 8
vae:
  params:
    embed_dim: 4
    ddconfig: {{z_channels: 4, ch: 8, ch_mult: [1, 2], num_res_blocks: 1, resolution: 16}}
data:
  train:
    target: dataset.videoP2P.VideoPromptToPromptMotionAug
    params: {{root_dirs: [{tmp}/ptp], num_frames: 2}}
"""


def test_train_cli_runs_checkpoints_and_resumes(tmp_path, monkeypatch):
    """Two steps with a validation preview and a checkpoint, then a resumed
    run to step 4, on the CPU with random weights (a one-layer text model
    stands in for CLIP ViT-L)."""
    from insv2v_torch.apps import train
    from insv2v_torch.utils import factory

    make_ptp_data(tmp_path / "ptp")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(tmp=tmp_path))
    monkeypatch.setattr(factory.ClipTextConfig, "vit_l_14", classmethod(
        lambda cls: cls(vocab_size=49408, hidden_size=32, num_layers=1, num_heads=2,
                        intermediate_size=64)))
    argv = ["--config", str(cfg), "--allow-random-weights", "--device", "cpu"]
    train.main(argv + ["--max-steps", "2"])
    expt = tmp_path / "experiments" / "tiny"
    assert (expt / "step_00000002.pt").exists()
    assert list((expt / "previews").glob("*.png"))
    train.main(argv + ["--max-steps", "4", "-r"])
    lines = [json.loads(line) for line in open(expt / "metrics.jsonl")]
    steps = [r["step"] for r in lines if "train_loss" in r]
    assert steps == [1, 2, 3, 4]
    assert all(np.isfinite(r["train_loss"]) for r in lines if "train_loss" in r)


def test_train_cli_refuses_random_weights_unless_asked(tmp_path):
    from insv2v_torch.apps import train

    make_ptp_data(tmp_path / "ptp")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(tmp=tmp_path))
    with pytest.raises(SystemExit):
        train.main(["--config", str(cfg), "--device", "cpu", "--max-steps", "1"])


