"""The port's schedules and window sampler (insv2v_torch.diffusion) against
the JAX package's, float32 on the CPU. JAX PRNG streams cannot be drawn in
torch, so each test replays the JAX key splits to get the JAX normals and
hands them to the port's sampler as its step noise."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.diffusion import samplers as jsamp
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.utils.convert import convert_unet3d_state_dict
from insv2v_torch.diffusion import samplers as tsamp
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
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


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JS, TS = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()


@pytest.mark.parametrize("kind,steps", [("ddim", 20), ("ddim", 7), ("ddpm", 3), ("ddpm", 50)])
def test_sampler_tables(kind, steps):
    want = jsched.make_sampler_tables(JS, steps, kind=kind)
    got = tsched.make_sampler_tables(TS, steps, kind=kind)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    for name in ("alpha_prod", "alpha_prod_prev", "variance"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("kind", ["ddim", "ddpm"])
def test_sampler_step(kind):
    """Tolerance 1e-5: float32 step arithmetic, coefficients rounded alike."""
    rs = np.random.RandomState(0)
    x, eps, noise = (rs.randn(2, 3, 4, 4, 4).astype(np.float32) for _ in range(3))
    jt = jsched.make_sampler_tables(JS, 10, kind=kind)
    tt = tsched.make_sampler_tables(TS, 10, kind=kind)
    for i in (0, 4, 9):
        wx, w0 = jsched.sampler_step(jt, jnp.asarray(x), jnp.asarray(eps), i, jnp.asarray(noise))
        gx, g0 = tsched.sampler_step(tt, torch.from_numpy(x), torch.from_numpy(eps), i,
                                     torch.from_numpy(noise))
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g0.numpy(), np.asarray(w0), rtol=1e-5, atol=1e-5)


def _probe_unet_pair():
    """A linear fake UNet (latent + 0.1 cond + context mean) in both packages."""
    def jprobe(params, sample, t, ctx, vsi):
        lat, cond = jnp.split(sample, 2, axis=-1)
        return lat + 0.1 * cond + jnp.mean(ctx, axis=(1, 2)).reshape(-1, 1, 1, 1, 1) + 1e-3 * t.reshape(-1, 1, 1, 1, 1)

    def tprobe(sample, t, ctx, vsi):
        lat, cond = sample.chunk(2, dim=-1)
        return lat + 0.1 * cond + ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1, 1) + 1e-3 * t.reshape(-1, 1, 1, 1, 1)

    return jprobe, tprobe


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_dual_cfg_eps(rescale):
    jprobe, tprobe = _probe_unet_pair()
    rs = np.random.RandomState(1)
    lat, cond = rs.randn(2, 3, 4, 4, 4).astype(np.float32), rs.randn(2, 3, 4, 4, 4).astype(np.float32)
    tc, tu = rs.randn(2, 5, 6).astype(np.float32), rs.randn(2, 5, 6).astype(np.float32)
    want = jsamp.dual_cfg_eps(jprobe, None, jnp.asarray(lat), jnp.asarray(cond), 321,
                              jnp.asarray(tu), jnp.asarray(tc), 7.5, 1.2, 0, rescale)
    got = tsamp.dual_cfg_eps(tprobe, torch.from_numpy(lat), torch.from_numpy(cond), 321,
                             torch.from_numpy(tu), torch.from_numpy(tc), 7.5, 1.2, 0, rescale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("total,fpw,nref", [(10, 16, 4), (32, 16, 4), (40, 16, 4), (10, 6, 2),
                                            (17, 8, 3)])
def test_split_windows(total, fpw, nref):
    want = jsamp.split_windows(total, fpw, nref)
    got = tsamp.split_windows(total, fpw, nref)
    assert [(w.start, w.num_frames, w.num_ref) for w in got] == \
        [(w.start, w.num_frames, w.num_ref) for w in want]


def jax_step_noises(rng, steps, shape):
    """The normals sample_video_window's scan draws: split, then normal."""
    out, key = [], rng
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(nkey, shape, dtype=jnp.float32)))
    return out


def tiny_unet_pair(seed=0):
    """A tiny port UNet with live motion modules, and the same weights as a
    Flax param tree (built without a Flax init, which is slow on the CPU)."""
    torch.manual_seed(seed)
    port = UNet3DConditionModel(UNetConfig.tiny())
    with torch.no_grad():
        for name, p in port.named_parameters():
            if "temporal_transformer.proj_out" in name:
                p.copy_(torch.randn_like(p) * 0.3)
    params = convert_unet3d_state_dict(port.state_dict())
    port.load_state_dict(torch_state_dict_from_flax(params, "unet3d"))
    return port.eval(), params


def test_window_with_anchoring_and_noise_matches_jax():
    """A DDPM follow-up window: ref-frame anchoring for half the steps and
    the JAX run's step noise handed in. Tolerance 1e-4: float32 through 4
    steps of the tiny UNet."""
    port, params = tiny_unet_pair()
    model = JUNet(cfg=JUNetCfg.tiny())
    rs = np.random.RandomState(2)
    lat, cond = rs.randn(1, 4, 8, 8, 4).astype(np.float32), rs.randn(1, 4, 8, 8, 4).astype(np.float32)
    tc, tu = rs.randn(1, 3, 12).astype(np.float32), rs.randn(1, 3, 12).astype(np.float32)
    ref = np.concatenate([rs.randn(1, 2, 8, 8, 4), np.zeros((1, 2, 8, 8, 4))], 1).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    steps = 4
    jt = jsched.make_sampler_tables(JS, steps, kind="ddpm")
    kw = dict(text_cfg=7.5, img_cfg=1.2, video_start_index=3, num_ref_frames=2,
              noise_correct_step=0.5)
    want = jsamp.sample_video_window(
        lambda p, s, t, c, v: model.apply({"params": p}, s, t, c, video_start_index=v),
        params, jt, jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(tc), jnp.asarray(tu), rng,
        latent_ref=jnp.asarray(ref), **kw)["latent"]
    noises = jax_step_noises(rng, steps, lat.shape)
    with torch.no_grad():
        got = tsamp.sample_video_window(
            port, tsched.make_sampler_tables(TS, steps, kind="ddpm"), torch.from_numpy(lat),
            torch.from_numpy(cond), torch.from_numpy(tc), torch.from_numpy(tu),
            latent_ref=torch.from_numpy(ref), step_noise=lambda i, s: torch.tensor(noises[i]),
            **kw)["latent"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_window_matches_golden_snapshot():
    """tests/golden/window_sampler.npz: the JAX window sampler with the
    params, inputs and key of tests/test_golden.py (DDPM, 3 steps).
    Tolerance 2e-4, the snapshot's own."""
    model = JUNet(cfg=JUNetCfg.tiny())
    params = model.init(jax.random.PRNGKey(15), jnp.zeros((1, 2, 8, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 12)))["params"]
    port = UNet3DConditionModel(UNetConfig.tiny())
    port.load_state_dict(torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                    "unet3d"))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(16), (1, 2, 8, 8, 4)))
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(17), (1, 2, 8, 8, 4)))
    tc = np.asarray(jax.random.normal(jax.random.PRNGKey(18), (1, 3, 12)))
    noises = jax_step_noises(jax.random.PRNGKey(19), 3, lat.shape)
    with torch.no_grad():
        got = tsamp.sample_video_window(
            port.eval(), tsched.make_sampler_tables(TS, 3, kind="ddpm"), torch.tensor(lat),
            torch.tensor(cond), torch.tensor(tc), torch.zeros(1, 3, 12), text_cfg=7.5,
            img_cfg=1.2, step_noise=lambda i, s: torch.tensor(noises[i]))["latent"]
    np.testing.assert_allclose(got.numpy(), np.load(os.path.join(GOLDEN, "window_sampler.npz"))["latent"],
                               atol=2e-4)

