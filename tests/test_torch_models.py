"""The port's models (insv2v_torch.models) against the JAX package's Flax
models and golden snapshots, at fixture size, float32 on the CPU, with one
weight set: the Flax params carried over by ``torch_state_dict_from_flax``.
Also the weight bridge both ways: ``convert_*_state_dict`` of the port's
state dict gives back the Flax tree leaf for leaf.

Tolerances: 2e-4 against the golden snapshots (their own tolerance in
tests/test_golden.py); 1e-4 against a live Flax run (float32 through a few
dozen layers, summation order differs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_text import ClipTextEncoder as JClip
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.models.vae import AutoencoderKL as JVae
from insv2v_tpu.models.vae import VaeConfig as JVaeCfg
from insv2v_tpu.utils.convert import (convert_clip_text_state_dict,
                                      convert_unet3d_state_dict, convert_vae_state_dict)
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.utils.convert import flatten, torch_state_dict_from_flax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4,
              resolution=16)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_port(module, params, kind):
    module.load_state_dict(torch_state_dict_from_flax(params, kind))
    return module.eval()


def assert_same_tree(got, want):
    fg, fw = flatten(got), flatten(want)
    assert set(fg) == set(fw)
    for k in fw:
        np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]), err_msg=str(k))


@pytest.fixture(scope="module")
def unet_golden_params():
    """The params of tests/test_golden.py::test_unet3d_tiny_golden."""
    x = jax.random.normal(jax.random.PRNGKey(10), (1, 2, 8, 8, 8))
    ctx = jax.random.normal(jax.random.PRNGKey(11), (1, 3, 12))
    params = JUNet(cfg=JUNetCfg.tiny()).init(jax.random.PRNGKey(12), x, jnp.array([321]),
                                             ctx)["params"]
    return np.asarray(x), np.asarray(ctx), np_tree(params)


def test_unet_matches_golden_snapshot(unet_golden_params):
    x, ctx, params = unet_golden_params
    port = load_port(UNet3DConditionModel(UNetConfig.tiny()), params, "unet3d")
    with torch.no_grad():
        eps = port(torch.tensor(x), torch.tensor([321]), torch.tensor(ctx),
                   video_start_index=2)
    np.testing.assert_allclose(eps.numpy(), np.load(os.path.join(GOLDEN, "unet3d_tiny.npz"))["eps"],
                               atol=2e-4)


# jitted once for both window starts (the start index is traced)
_flax_unet_apply = jax.jit(lambda p, x, t, c, vsi: JUNet(cfg=JUNetCfg.tiny()).apply(
    {"params": p}, x, t, c, video_start_index=vsi))


@pytest.mark.parametrize("vsi", [1, 6])  # 6 + 4 frames overruns the 8-row PE table
def test_unet_matches_flax_with_live_motion_modules(unet_golden_params, vsi):
    """Motion modules' proj_out is zero at init, which hides the temporal
    path: give it random weights on both sides first."""
    _, _, params = unet_golden_params
    rs = np.random.RandomState(vsi)
    flat = flatten(params)
    for path in flat:
        if path[0].startswith(("down_blocks", "up_blocks")) and "motion_modules" in path[1] \
                and path[2] == "proj_out":
            flat[path] = (0.3 * rs.randn(*flat[path].shape)).astype(np.float32)
    live = {}
    for path, v in flat.items():
        node = live
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    x = rs.randn(2, 4, 8, 8, 8).astype(np.float32)
    ctx = rs.randn(2, 3, 12).astype(np.float32)
    t = np.array([10, 700])
    want = _flax_unet_apply(live, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), vsi)
    port = load_port(UNet3DConditionModel(UNetConfig.tiny()), live, "unet3d")
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   video_start_index=vsi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_unet_weight_bridge_round_trip(unet_golden_params):
    _, _, params = unet_golden_params
    port = load_port(UNet3DConditionModel(UNetConfig.tiny()), params, "unet3d")
    assert_same_tree(convert_unet3d_state_dict(port.state_dict()), params)


def test_unet_fresh_state_dict_has_the_flax_layout(unet_golden_params):
    """Independent of the inverse converter: a freshly built port UNet's
    state dict converts to exactly the Flax tree's paths and shapes."""
    _, _, params = unet_golden_params
    got = convert_unet3d_state_dict(UNet3DConditionModel(UNetConfig.tiny()).state_dict())
    shapes = lambda tree: {k: np.shape(v) for k, v in flatten(tree).items()}
    assert shapes(got) == shapes(params)


@pytest.fixture(scope="module")
def vae_golden_params():
    """The params of tests/test_golden.py::test_vae_tiny_golden."""
    x = jax.random.normal(jax.random.PRNGKey(13), (1, 16, 16, 3))
    model = JVae(cfg=JVaeCfg(**VAE_KW))
    params = model.init(jax.random.PRNGKey(14), x, sample_posterior=False)["params"]
    return np.asarray(x), np_tree(params)


def test_vae_matches_golden_snapshot(vae_golden_params):
    x, params = vae_golden_params
    port = load_port(AutoencoderKL(VaeConfig(**VAE_KW)), params, "vae")
    golden = np.load(os.path.join(GOLDEN, "vae_tiny.npz"))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        rec = port.decode(z)
    np.testing.assert_allclose(z.numpy(), golden["z"], atol=2e-4)
    np.testing.assert_allclose(rec.numpy(), golden["rec"], atol=2e-4)


def test_vae_sampled_encode_and_decode_match_flax(vae_golden_params):
    """32x32 images put 16x16 = 256 positions into the mid-block attention,
    the port's flash dispatch; the posterior sample takes the same normals
    the Flax encode draws from its key."""
    _, params = vae_golden_params
    model = JVae(cfg=JVaeCfg(**VAE_KW))
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_z = model.apply({"params": params}, jnp.asarray(x), key, method=JVae.encode)
    eps = jax.random.normal(key, want_z.shape, dtype=want_z.dtype)
    want_rec = model.apply({"params": params}, want_z, method=JVae.decode)
    port = load_port(AutoencoderKL(VaeConfig(**VAE_KW)), params, "vae")
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x), torch.from_numpy(np.asarray(eps)))
        rec = port.decode(torch.from_numpy(np.asarray(want_z)))
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=1e-4)
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), atol=1e-4)


def test_vae_weight_bridge_round_trip(vae_golden_params):
    _, params = vae_golden_params
    port = load_port(AutoencoderKL(VaeConfig(**VAE_KW)), params, "vae")
    assert_same_tree(convert_vae_state_dict(port.state_dict()), params)


CLIP_KW = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_positions=77)


@pytest.fixture(scope="module")
def clip_params():
    ids = np.random.RandomState(0).randint(0, 100, size=(2, 77)).astype(np.int32)
    params = JClip(JClipCfg(**CLIP_KW)).init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    return ids, np_tree(params)


def test_clip_text_matches_flax(clip_params):
    ids, params = clip_params
    want = JClip(JClipCfg(**CLIP_KW)).apply({"params": params}, jnp.asarray(ids))
    port = load_port(ClipTextEncoder(ClipTextConfig(**CLIP_KW)), params, "clip_text")
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_clip_text_weight_bridge_round_trip(clip_params):
    _, params = clip_params
    port = load_port(ClipTextEncoder(ClipTextConfig(**CLIP_KW)), params, "clip_text")
    assert_same_tree(convert_clip_text_state_dict(port.state_dict()), params)
