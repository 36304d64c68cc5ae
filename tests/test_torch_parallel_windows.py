"""The port's sharded inference (insv2v_torch.parallel: frame_parallel, the
frame-sharded GroupNorm, motion modules and sampler, and the batch-sharded
window) against the JAX package's single-device ``sample_video_window``,
on two gloo processes spawned on the CPU.

The inputs and tolerance are tests/test_sharded_inference.py's (the tiny
UNet, DDIM 2 steps, text CFG 4.0, video CFG 1.3; the follow-up window
with a zero ``latent_ref``, 2 ref frames and ``noise_correct_step`` 0.5;
rtol 5e-4, atol 1e-4) at 2 videos of 8 frames: split by frames (4 a
rank) or by videos (1 a rank). The tiny UNet's last level has one pixel,
so the motion modules' exchange there splits unevenly (1 and 0 pixels).
The weights are tests/test_torch_diffusion.py's tiny pair.
Beyond JAX, the port's sharded DDPM windows (step noise drawn whole and
sliced, flows, guidance rescale) equal its unsharded ones at the same
tolerance, and a frame-sharded GroupNorm equals the unsharded one to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.diffusion import samplers as jsamp
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_torch.diffusion import samplers as tsamp
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.ops.norms import group_norm
from insv2v_torch.parallel import dist as pdist
from insv2v_torch.parallel.inference import batch_sharded_window, frame_sharded_window
from test_torch_diffusion import tiny_unet_pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, F, RANKS = 2, 8, 2
KW = dict(text_cfg=4.0, img_cfg=1.3)
FOLLOW = dict(num_ref_frames=2, noise_correct_step=0.5)
RTOL, ATOL = 5e-4, 1e-4


@pytest.fixture(scope="module")
def windows():
    """The JAX first and follow-up windows on the inputs, then every rank's
    sharded results."""
    port, params = tiny_unet_pair()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    model = JUNet(cfg=JUNetCfg.tiny())
    rngs = jax.random.PRNGKey(0)
    lat = jax.random.normal(rngs, (B, F, 8, 8, 4))
    cond = jax.random.normal(jax.random.fold_in(rngs, 1), (B, F, 8, 8, 4))
    tc = jax.random.normal(jax.random.fold_in(rngs, 2), (B, 3, 12))
    tu = jnp.zeros((B, 3, 12))
    tables = jsched.make_sampler_tables(jsched.DiffusionSchedule.create(), 2, kind="ddim")
    apply = lambda p, s, t, c, v: model.apply({"params": p}, s, t, c, video_start_index=v)

    def run(follow):
        extra = dict(latent_ref=jnp.zeros_like(lat), **FOLLOW) if follow else {}
        fn = lambda p, l, c, a, b: jsamp.sample_video_window(
            apply, p, tables, l, c, a, b, jax.random.PRNGKey(3), **KW, **extra)["latent"]
        return np.asarray(jax.jit(fn)(params, lat, cond, tc, tu))

    want = {"first": run(False), "follow_up": run(True)}
    inputs = {k: np.asarray(v) for k, v in dict(lat=lat, cond=cond, tc=tc, tu=tu).items()}
    ranks = pdist.spawn(_rank, RANKS, sd, inputs, timeout_s=240)
    return want, ranks


# --- the ranks' side (run in spawned processes) ----------------------------------

def _rank(group, sd, inputs):
    torch.set_num_threads(1)
    unet = UNet3DConditionModel(UNetConfig.tiny())
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    unet.eval()
    lat, cond, tc, tu = (torch.from_numpy(inputs[k]) for k in ("lat", "cond", "tc", "tu"))
    out = {}
    with torch.no_grad():
        ddim = tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), 2, kind="ddim")
        for name, extra in (("first", {}),
                            ("follow_up", dict(latent_ref=torch.zeros_like(lat), **FOLLOW))):
            out[f"frames_{name}"] = frame_sharded_window(
                unet, ddim, lat, cond, tc, tu, group, **KW, **extra)["latent"].numpy()
            out[f"batch_{name}"] = batch_sharded_window(
                unet, ddim, lat, cond, tc, tu, group, **KW, **extra)["latent"].numpy()
        # a planted fault: the sampler's sum of the ref frames' deltas (its
        # one (B, 1, h, w, C) all-reduce) kept to this rank's frames
        reduce = group.all_reduce_sum
        group.all_reduce_sum = lambda t: t if t.ndim == 5 else reduce(t)
        out["frames_follow_up_fault"] = frame_sharded_window(
            unet, ddim, lat, cond, tc, tu, group, **KW, latent_ref=torch.zeros_like(lat),
            **FOLLOW)["latent"].numpy()
        del group.all_reduce_sum
        out.update(_port_ddpm_windows(unet, lat, cond, tc, tu, group))
    out.update(_group_norm_check(group))
    out.update(_transport_check(group))
    return out


def _port_ddpm_windows(unet, lat, cond, tc, tu, group):
    """DDPM follow-up windows with step noise drawn at the full shape from
    one seeded source: frame-sharded with flows and guidance rescale, and
    batch-sharded, each beside the unsharded window on the same inputs."""
    gen = torch.Generator().manual_seed(5)
    flows = torch.randn(F, 2, 8, 8, 2, generator=gen) * 2.0
    masks = (torch.rand(F, 2, 8, 8, 1, generator=gen) > 0.3).float()
    ref = torch.randn(lat.shape, generator=gen)
    noise = lambda i, shape: torch.randn(shape, generator=torch.Generator().manual_seed(50 + i))
    ddpm = tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), 3, kind="ddpm")
    kw = dict(KW, latent_ref=ref, step_noise=noise, video_start_index=3, **FOLLOW)
    frame_kw = dict(kw, flows=flows, flow_masks=masks, guidance_rescale=0.7)
    return {
        "ddpm_frames": frame_sharded_window(unet, ddpm, lat, cond, tc, tu, group,
                                            **frame_kw)["latent"].numpy(),
        "ddpm_frames_want": tsamp.sample_video_window(unet, ddpm, lat, cond, tc, tu,
                                                      **frame_kw)["latent"].numpy(),
        "ddpm_batch": batch_sharded_window(unet, ddpm, lat, cond, tc, tu, group,
                                           **kw)["latent"].numpy(),
        "ddpm_batch_want": tsamp.sample_video_window(unet, ddpm, lat, cond, tc, tu,
                                                     **kw)["latent"].numpy()}


def _group_norm_check(group):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, F, 4, 4, 16, generator=gen) * 3 + 1
    scale, bias = torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    frames = pdist.shard_range(F, group.rank, group.size)
    got = group_norm(x[:, frames], scale, bias, num_groups=4, group=group)
    want = group_norm(x, scale, bias, num_groups=4)[:, frames]
    return {"group_norm_err": (got - want).abs().max().item()}


def _transport_check(group):
    """all_to_all_dims there and back (an uneven split of 5 over 2) and
    all_gather_dim, on tensors that name their rank."""
    x = torch.arange(3 * 5, dtype=torch.float32).reshape(1, 3, 5) + 100 * group.rank
    there = group.all_to_all_dims(x, split_dim=2, cat_dim=1)
    sizes = [len(p) for p in torch.arange(5).tensor_split(group.size)]
    back = group.all_to_all_dims(there, split_dim=1, cat_dim=2, cat_sizes=sizes)
    gathered = group.all_gather_dim(x, 0)
    return {"there_shape": tuple(there.shape), "round_trip": torch.equal(back, x),
            "gathered": gathered.numpy(), "sent": dict(group.sent)}


# --- tests -----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["first", "follow_up"])
def test_frame_sharded_window_matches_jax(windows, which):
    want, ranks = windows
    for out in ranks:
        np.testing.assert_allclose(out[f"frames_{which}"], want[which], rtol=RTOL, atol=ATOL)


def test_frame_sharded_window_without_the_ref_delta_reduction_fails(windows):
    """The check above bites: with the ref deltas summed over this rank's
    frames only, the follow-up window leaves the tolerance on every rank
    (rank 1 holds no ref frame)."""
    want, ranks = windows
    for out in ranks:
        assert not np.allclose(out["frames_follow_up_fault"], want["follow_up"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("which", ["first", "follow_up"])
def test_batch_sharded_window_matches_jax(windows, which):
    want, ranks = windows
    for out in ranks:
        np.testing.assert_allclose(out[f"batch_{which}"], want[which], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("how", ["frames", "batch"])
def test_sharded_ddpm_windows_equal_unsharded(windows, how):
    """Step noise drawn whole and sliced; frames also with flows (sliced by
    query frame, the refs' deltas gathered) and guidance rescale (its std
    over every rank's frames)."""
    _, ranks = windows
    for out in ranks:
        np.testing.assert_allclose(out[f"ddpm_{how}"], out[f"ddpm_{how}_want"], rtol=RTOL,
                                   atol=ATOL)
        assert np.isfinite(out[f"ddpm_{how}"]).all()


def test_group_norm_under_a_frame_group(windows):
    _, ranks = windows
    assert all(out["group_norm_err"] <= 1e-6 for out in ranks)


def test_transport_exchanges_round_trip(windows):
    _, ranks = windows
    for r, out in enumerate(ranks):
        assert out["there_shape"] == (1, 6, 3 if r == 0 else 2)
        assert out["round_trip"]
        np.testing.assert_array_equal(
            out["gathered"], np.stack([np.arange(15.0).reshape(3, 5) + 100 * i
                                       for i in range(RANKS)]))
        assert out["sent"]["all_to_all"] > 0 and out["sent"]["all_gather"] > 0
