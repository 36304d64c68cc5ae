"""The port's trainer (insv2v_torch.training.trainer) against the JAX
package's: the motion mask, one microbatch's loss and motion gradients,
one accumulated step, at fixture size in float32 on the CPU, with one
weight set on both sides and the JAX run's random draws replayed into the
port. The optimizers, checkpoints, validation, datasets and the CLI are in
tests/test_torch_training_parts.py.

Tolerances are stated per test: float32 through the tiny UNet's forward
and backward agrees to ~1e-6 relative; the checks use 1e-4 of each
gradient's largest entry, 1e-5 relative on losses."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_text import ClipTextEncoder as JClip
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.models.vae import AutoencoderKL as JVae
from insv2v_tpu.models.vae import VaeConfig as JVaeCfg
from insv2v_tpu.parallel.mesh import make_mesh
from insv2v_tpu.training import trainer as jtrainer
from insv2v_tpu.utils.convert import (convert_clip_text_state_dict,
                                      convert_unet3d_state_dict, convert_vae_state_dict)
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.training import trainer as ttrainer
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=50, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)
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


def jax_draws(key, b, latent_shape):
    """The draws of the JAX ``_microbatch_loss`` for one key, by name."""
    _, r_drop, r_eps, r_t, r_enc1, r_enc2 = jax.random.split(key, 6)
    flat_shape = (b * latent_shape[0],) + latent_shape[1:]
    return {"enc_cond": np.array(jax.random.normal(r_enc1, flat_shape, jnp.float32)),
            "enc_edit": np.array(jax.random.normal(r_enc2, flat_shape, jnp.float32)),
            "drop": np.array(jax.random.bernoulli(r_drop, 0.1, (b,))),
            "eps": np.array(jax.random.normal(r_eps, (b,) + latent_shape, jnp.float32)),
            "t": np.array(jax.random.randint(r_t, (b,), 0, 1000))}


LATENT = (FRAMES, SIZE // 2, SIZE // 2, 4)  # one VAE downsample


def jax_mask_as_port_keys(params):
    """The JAX trainable mask, re-keyed to the port's state-dict names."""
    mask = jtrainer.motion_param_mask(params)
    sd = torch_state_dict_from_flax(
        jax.tree_util.tree_map(lambda m: np.float32(m), mask), "unet3d")
    return {k: bool(v.item()) for k, v in sd.items()}


def assert_grads_close(got, want, names, rel=1e-4):
    for name in names:
        w = want[name]
        np.testing.assert_allclose(got[name], w, atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def jax_grads_as_port(grads_tree):
    return {k: v.numpy() for k, v in torch_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads_tree), "unet3d").items()}


# --- the motion mask ------------------------------------------------------------

def test_motion_mask_selects_the_same_tensors_as_jax(jax_setup):
    _, unet_p, vae_p, clip_p = jax_setup
    unet, _, _ = port_models(unet_p, vae_p, clip_p)
    got = ttrainer.motion_param_mask(dict(unet.named_parameters()))
    want = jax_mask_as_port_keys(unet_p)
    assert got == want
    assert 0 < sum(got.values()) < len(got)


def test_cast_frozen_to_bf16_keeps_motion_tensors_float32(jax_setup):
    _, unet_p, vae_p, clip_p = jax_setup
    unet, _, _ = port_models(unet_p, vae_p, clip_p)
    cast = ttrainer.cast_frozen_to_bf16(unet.state_dict())
    want = jax_mask_as_port_keys(unet_p)
    jcast = torch_state_dict_from_flax(jax.tree_util.tree_map(
        lambda p: np.float32(p.dtype == jnp.float32),
        jtrainer.cast_frozen_to_bf16(unet_p)), "unet3d")
    for k, v in cast.items():
        assert v.dtype == (torch.float32 if want[k] else torch.bfloat16), k
        assert bool(jcast[k].item()) == want[k], k


# --- one microbatch and one step against the JAX trainer --------------------------

@pytest.fixture(scope="module")
def jax_step(jax_setup):
    """The JAX trainer's step (accum 2 of 2) from a fresh state, taken
    apart so that one compile serves it: the loss and gradient of each
    microbatch with the step's keys (``_train_step`` splits
    fold_in(rng, step) into accum keys), their means, and the trainer's
    optimizer applied to the mean gradient, as ``_train_step`` does."""
    trainer, unet_p, vae_p, clip_p = jax_setup
    state = trainer.create_state(unet_p, vae_p, clip_p)
    batch = make_batch()
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 0), ACCUM)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, m, key: trainer._microbatch_loss(p, state, m, key)))
    losses, trees = [], []
    for i, key in enumerate(keys):
        micro = {k: jnp.asarray(v[i * MICRO:(i + 1) * MICRO]) for k, v in batch.items()}
        loss, g = grad_fn(state.params, micro, key)
        losses.append(float(loss))
        trees.append(g)
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / ACCUM, *trees)
    updates, _ = trainer._tx.update(mean, state.opt_state, state.params)
    new_params = jax_grads_as_port(optax.apply_updates(state.params, updates))
    return dict(batch=batch, losses=losses, grads=[jax_grads_as_port(g) for g in trees],
                mean_grads=jax_grads_as_port(mean), loss=sum(losses) / ACCUM,
                new_params=new_params, draws=[jax_draws(key, MICRO, LATENT) for key in keys])


def port_trainer(jax_setup, **cfg):
    _, unet_p, vae_p, clip_p = jax_setup
    unet, vae, text = port_models(unet_p, vae_p, clip_p)
    cfg = dict(dict(lr=1e-3, accumulate_grad_batches=ACCUM), **cfg)
    trainer = ttrainer.Trainer(unet, vae, text, ttrainer.TrainConfig(**cfg))
    return trainer, trainer.create_state()


def test_microbatch_loss_and_grads_match_jax(jax_setup, jax_step):
    """Replayed draws (posterior normals, drop mask, eps, t): loss to 1e-5
    relative, every motion gradient to 1e-4 of its largest entry."""
    trainer, state = port_trainer(jax_setup)
    batch = jax_step["batch"]
    micro = {k: v[:MICRO] for k, v in batch.items()}
    loss = trainer.microbatch_loss(micro, jax_step["draws"][0])
    params = dict(trainer.unet.named_parameters())
    names = list(state.params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    np.testing.assert_allclose(loss.item(), jax_step["losses"][0], rtol=1e-5)
    assert_grads_close({n: g.numpy() for n, g in zip(names, grads)}, jax_step["grads"][0],
                       names)


def test_train_step_matches_jax_trainer(jax_setup, jax_step):
    """One accum-2 step: the mean loss to 1e-5 relative, the mean motion
    gradient to 1e-4 of its largest entry, the motion parameters after the
    Adam step to 1e-5 (1 % of lr 1e-3: a first Adam step is
    lr * g / (|g| + eps), so an entry whose gradient is near zero magnifies
    the float32 gradient difference), and nothing frozen moves."""
    trainer, state = port_trainer(jax_setup)
    before = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    loss, grads = trainer.accumulate_grads(state, jax_step["batch"], draws=jax_step["draws"])
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=1e-5)
    assert_grads_close({n: g.numpy() for n, g in zip(state.params, grads)},
                       jax_step["mean_grads"], list(state.params))
    state, metrics = trainer.train_step(state, jax_step["batch"], draws=jax_step["draws"])
    assert state.step == 1
    np.testing.assert_allclose(metrics["train_loss"], jax_step["loss"], rtol=1e-5)
    for n, p in trainer.unet.named_parameters():
        if n in state.params:
            np.testing.assert_allclose(p.detach().numpy(), jax_step["new_params"][n],
                                       atol=1e-5, err_msg=n)
            assert not torch.equal(p, before[n]) or not before[n].any(), n
        else:
            assert torch.equal(p, before[n]), n


def test_remat_changes_no_number(jax_setup, jax_step):
    """Block checkpointing recomputes the same float32 ops: the same loss
    and gradients bit for bit."""
    out = []
    for remat in (False, True):
        trainer, state = port_trainer(jax_setup)
        trainer.unet.cfg = UNetConfig.tiny(in_channels=8, out_channels=4, remat=remat)
        out.append(trainer.accumulate_grads(state, jax_step["batch"], draws=jax_step["draws"]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_from_a_generator_updates_only_motion_params(jax_setup):
    trainer, state = port_trainer(jax_setup, loss_type="l1", prediction_type="sample")
    before = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    losses = [trainer.train_step(state, make_batch(seed=1), gen)[1]["train_loss"]
              for _ in range(2)]
    assert all(np.isfinite(losses)) and state.step == 2
    moved = {n for n, p in trainer.unet.named_parameters() if not torch.equal(p, before[n])}
    assert moved and moved <= set(state.params)


def test_training_modules_import_no_jax():
    code = ("import sys\n"
            "import insv2v_torch.training.trainer, insv2v_torch.training.validation\n"
            "import insv2v_torch.apps.train, insv2v_torch.utils.checkpoint\n"
            "import insv2v_torch.data.datasets, insv2v_torch.ops.fused_norm\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'insv2v_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
