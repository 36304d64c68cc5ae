"""The port's flow-compensated edit against the JAX package's, float32 on the
CPU: the resize and warp ops, RAFT (its correlation pieces, the tiny and
the full configuration), the flow estimators and window flow stacks, the
flow branch of the window sampler and a two-window motion-compensated
VideoEditor edit. Weights cross over through the JAX converters and the
port's ``torch_state_dict_from_flax``; inputs come from seeded numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from insv2v_tpu.diffusion import samplers as jsamp
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.diffusion.pipeline import VideoEditor as JEditor
from insv2v_tpu.models import raft as jraft
from insv2v_tpu.models.clip_text import ClipTextConfig as JClipCfg
from insv2v_tpu.models.clip_text import ClipTextEncoder as JClip
from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.models.vae import AutoencoderKL as JVae
from insv2v_tpu.models.vae import VaeConfig as JVaeCfg
from insv2v_tpu.ops import resize as jresize
from insv2v_tpu.utils import flow as jflow
from insv2v_tpu.utils.convert import convert_raft_state_dict
from insv2v_torch.diffusion import samplers as tsamp
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.models import raft as traft
from insv2v_torch.ops import resize as tresize
from insv2v_torch.utils import flow as tflow
from insv2v_torch.utils.checkpoint import load_raft_state_dict
from insv2v_torch.utils.convert import torch_state_dict_from_flax
from test_torch_pipeline import (CLIP_KW, VAE_KW, ReplayNoise, TinyTokenizer,
                                 jax_editor_normals, tiny_models)


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
    return torch.from_numpy(np.array(a))


def leaving_flow(rs, n, h, w, scale=4.0):
    """A smooth flow field whose vectors carry many pixels out of the image."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(xx / 3.0) * scale, np.cos(yy / 2.0) * scale], -1)
    return (base[None] + rs.randn(n, h, w, 2) * scale).astype(np.float32)


# --- resize and warp ----------------------------------------------------------


@pytest.mark.parametrize("n,h,w,c", [(2, 7, 11, 3), (1, 13, 5, 4), (3, 9, 9, 1)])
def test_warp_image_matches_jax(n, h, w, c):
    """Tolerance 1e-5: float32 bilinear weights, corners zeroed alike."""
    rs = np.random.RandomState(h * w)
    img = rs.randn(n, h, w, c).astype(np.float32)
    flow = leaving_flow(rs, n, h, w)
    got = tresize.warp_image(np_t(img), np_t(flow)).numpy()
    want = np.asarray(jax.jit(jresize.warp_image)(img, flow))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got == 0).any() and not (got == 0).all()  # some samples left the image


@pytest.mark.parametrize("src,dst", [((9, 13), (4, 6)), ((5, 7), (11, 17)), ((12, 8), (12, 20))])
def test_resize_flow_matches_jax(src, dst):
    """Tolerance 1e-5 on vectors of a few pixels."""
    rs = np.random.RandomState(sum(src))
    flow = leaving_flow(rs, 2, *src)
    got = tresize.resize_flow(np_t(flow), *dst).numpy()
    want = np.asarray(jax.jit(jresize.resize_flow, static_argnums=(1, 2))(flow, *dst))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("src,dst", [((9, 13), (4, 6)), ((5, 7), (11, 17)), ((6, 10), (3, 25))])
def test_bilinear_resize_matches_jax_and_interpolate(src, dst, align):
    """Against the JAX function to 1e-5, and against F.interpolate (bilinear,
    no antialias) to 1e-5 at down- and up-scales, non-square."""
    rs = np.random.RandomState(dst[0])
    x = rs.randn(2, *src, 3).astype(np.float32)
    got = tresize.bilinear_resize(np_t(x), *dst, align_corners=align).numpy()
    want = np.asarray(jax.jit(jresize.bilinear_resize, static_argnums=(1, 2, 3))(
        x, *dst, align))
    np.testing.assert_allclose(got, want, atol=1e-5)
    interp = F.interpolate(np_t(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                           align_corners=align, antialias=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, interp.numpy(), atol=1e-5)


@pytest.mark.parametrize("src,dst", [((9, 13), (4, 6)), ((5, 7), (11, 17))])
def test_nearest_resize_matches_jax(src, dst):
    x = np.random.RandomState(1).randn(2, *src, 3).astype(np.float32)
    got = tresize.nearest_resize(np_t(x), *dst).numpy()
    want = jax.jit(jresize.nearest_resize, static_argnums=(1, 2))(x, *dst)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("h,w", [(9, 13), (16, 7)])
def test_check_flow_consistency_matches_jax(h, w):
    """The mask exactly wherever both of its inequalities are more than 1e-4
    from their thresholds (ties aside, float32 rounding cannot flip a
    pixel there), which is nearly every pixel of these seeded flows."""
    rs = np.random.RandomState(h)
    fwd = leaving_flow(rs, 2, h, w, scale=0.3)
    bwd = -fwd + rs.randn(2, h, w, 2).astype(np.float32) * 0.3
    got = tresize.check_flow_consistency(np_t(fwd), np_t(bwd)).numpy()
    want = np.asarray(jax.jit(jresize.check_flow_consistency)(fwd, bwd))
    bw = np.asarray(jax.jit(jresize.warp_image)(bwd, fwd))
    u, v, u2, v2 = fwd[..., 0], fwd[..., 1], bw[..., 0], bw[..., 1]
    rt = (u + u2) ** 2 + (v + v2) ** 2 - (0.01 * (u * u + v * v + u2 * u2 + v2 * v2) + 0.5)
    gx = (np.roll(u, -1, 2) - np.roll(u, 1, 2)) * 0.5
    gy = (np.roll(v, -1, 1) - np.roll(v, 1, 1)) * 0.5
    edge = gx * gx + gy * gy - (0.01 * (u * u + v * v) + 0.002)
    away = (np.abs(rt) > 1e-4) & (np.abs(edge) > 1e-4)
    assert away.mean() > 0.95
    np.testing.assert_array_equal(got[away], want[away])
    assert 0 < want.mean() < 1


# --- RAFT ---------------------------------------------------------------------


def test_correlation_pyramid_and_lookup_match_jax():
    """Radius 2 on a non-square 5x7 map with 3 levels (the last pools a
    1-wide axis), at coordinates that leave the map: the lookup's channel
    order (x offset on the major index) shows against the JAX function.
    Tolerance 1e-5."""
    rs = np.random.RandomState(0)
    f1, f2 = (rs.randn(2, 5, 7, 8).astype(np.float32) for _ in range(2))
    got = traft.correlation_pyramid(np_t(f1), np_t(f2), 3)
    want = jax.jit(jraft.correlation_pyramid, static_argnums=2)(f1, f2, 3)
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in want]
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5)
    gy, gx = np.mgrid[0:5, 0:7].astype(np.float32)
    coords = np.stack([gx, gy], -1)[None] + rs.randn(2, 5, 7, 2).astype(np.float32) * 2.5
    look = traft.corr_lookup(got, np_t(coords), 2).numpy()
    want_look = np.asarray(jax.jit(jraft.corr_lookup, static_argnums=2)(want, coords, 2))
    assert look.shape == (2, 5, 7, 3 * 25)
    np.testing.assert_allclose(look, want_look, atol=1e-5)
    # the transposed (y-major) order would differ: the check above can see it
    swapped = look.reshape(2, 5, 7, 3, 5, 5).swapaxes(-1, -2).reshape(look.shape)
    assert np.abs(swapped - want_look).max() > 1e-2


def test_convex_upsample_matches_jax():
    """A non-uniform mask over a non-square 3x5 map. Tolerance 1e-5."""
    rs = np.random.RandomState(1)
    flow = rs.randn(2, 3, 5, 2).astype(np.float32)
    mask = rs.randn(2, 3, 5, 576).astype(np.float32) * 2
    got = traft.convex_upsample(np_t(flow), np_t(mask)).numpy()
    want = np.asarray(jax.jit(jraft.convex_upsample)(flow, mask))
    assert got.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def seeded_raft(cfg, seed=0):
    """A port RAFT with seeded weights, the cnet's BatchNorm statistics and
    affine made non-trivial."""
    torch.manual_seed(seed)
    model = traft.RAFT(cfg).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, traft.FrozenBatchNorm2d):
                m.running_mean.copy_(torch.randn_like(m.running_mean) * 0.1)
                m.running_var.copy_(torch.rand_like(m.running_var) + 0.5)
                m.weight.copy_(1 + 0.1 * torch.randn_like(m.weight))
                m.bias.copy_(0.1 * torch.randn_like(m.bias))
    return model


@pytest.mark.parametrize("cfg_name,size,iters,tol", [("tiny", (32, 40), None, 1e-4),
                                                      ("full", (128, 128), 3, 5e-3)])
def test_raft_matches_jax(cfg_name, size, iters, tol):
    """RAFT end to end on the same weights: ``RaftConfig.tiny()`` (3
    iterations) to 1e-4, and the full configuration on a 128x128 pair with
    3 iterations (the JAX package's own oracle test) to 5e-3: float32
    through 22 convolutions a side and a 4-level correlation, whose
    rounding the GRU iterations carry into flows of several pixels."""
    cfg = traft.RaftConfig.tiny() if cfg_name == "tiny" else traft.RaftConfig()
    jcfg = jraft.RaftConfig.tiny() if cfg_name == "tiny" else jraft.RaftConfig()
    model = seeded_raft(cfg)
    params = convert_raft_state_dict(model.state_dict())
    rs = np.random.RandomState(0)
    im1 = (rs.randn(1, *size, 3) * 0.3).astype(np.float32)
    im2 = np.roll(im1, 3, axis=2)
    with torch.no_grad():
        got = model(np_t(im1), np_t(im2), iters=iters).numpy()
    want = np.asarray(jax.jit(lambda p, a, b: jraft.RAFT(cfg=jcfg).apply(
        {"params": p}, a, b, iters=iters))(params, jnp.asarray(im1), jnp.asarray(im2)))
    assert got.shape == (1, *size, 2)
    np.testing.assert_allclose(got, want, atol=tol)


def test_raft_state_dict_round_trips_through_flax():
    """The port's RAFT state dict -> the JAX converter -> back: every key
    (the BatchNorms' running statistics and the twice-registered norm3
    among them) and value, and it loads strictly but for the batch
    counters."""
    model = seeded_raft(traft.RaftConfig.tiny())
    back = torch_state_dict_from_flax(convert_raft_state_dict(model.state_dict()), "raft")
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    assert any(k.endswith("downsample.1.running_var") for k in back)
    fresh = traft.RAFT(traft.RaftConfig.tiny())
    load_raft_state_dict(fresh, {"module." + k: v for k, v in back.items()})
    with pytest.raises(ValueError, match="unknown"):
        load_raft_state_dict(fresh, dict(back, extra=torch.zeros(1)))


def test_raft_flow_pads_and_loads_weights(tmp_path):
    """RaftFlow on an odd 36x44 pair: zero-padded to 40x48 at the bottom
    and right and cropped back, as the JAX RaftFlow does, against the JAX
    RAFT on the same weights (tolerance 1e-4); the same weights from a
    princeton-vl-style .pth (``module.`` prefix) give the same flow; no
    weights and no ``allow_random`` raises."""
    cfg = traft.RaftConfig.tiny()
    est = tflow.RaftFlow(cfg=cfg, allow_random=True, device="cpu", seed=3)
    rs = np.random.RandomState(2)
    q, r = (np.clip(rs.randn(36, 44, 3) * 0.4, -1, 1).astype(np.float32) for _ in range(2))
    got = est(q, r)
    params = convert_raft_state_dict(est.model.state_dict())
    pad = lambda im: jnp.asarray(np.pad(im, ((0, 4), (0, 4), (0, 0))))[None]
    want = np.asarray(jax.jit(lambda p, a, b: jraft.RAFT(cfg=jraft.RaftConfig.tiny()).apply(
        {"params": p}, a, b))(params, pad(q), pad(r)))[0, :36, :44]
    assert got.shape == (36, 44, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)
    path = str(tmp_path / "raft.pth")
    torch.save({"module." + k: v for k, v in est.model.state_dict().items()}, path)
    loaded = tflow.RaftFlow(weights_path=path, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(loaded(q, r), got)
    batch = est.batch(np.stack([q, r]), np.stack([r, q])).numpy()
    np.testing.assert_allclose(batch[0], got, atol=1e-5)
    with pytest.raises(ValueError, match="pretrained weights"):
        tflow.RaftFlow(cfg=cfg, device="cpu")


def test_flow_estimators_match_jax(monkeypatch):
    """Farneback gives the JAX package's flow bit for bit (the same cv2
    call); ``auto`` without RAFT weights warns and takes Farneback; RAFT
    without a GPU raises unless asked for the CPU."""
    monkeypatch.delenv("INSV2V_RAFT_WEIGHTS", raising=False)
    rs = np.random.RandomState(3)
    q = np.clip(rs.randn(24, 32, 3) * 0.5, -1, 1).astype(np.float32)
    r = np.roll(q, 2, axis=1)
    np.testing.assert_array_equal(tflow.FarnebackFlow()(q, r), jflow.FarnebackFlow()(q, r))
    np.testing.assert_array_equal(tflow.ZeroFlow()(q, r), jflow.ZeroFlow()(q, r))
    with pytest.warns(UserWarning, match="Farneback"):
        assert isinstance(tflow.get_flow_estimator(), tflow.FarnebackFlow)
    with pytest.raises(ValueError, match="unknown"):
        tflow.get_flow_estimator("optical")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tflow.RaftFlow(cfg=traft.RaftConfig.tiny(), allow_random=True)


class AnalyticFlow:
    """A deterministic estimator: a flow field from the two frames' means
    and a fixed spatial pattern (a few pixels, some leaving the image)."""

    def __call__(self, query, ref):
        h, w = query.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        d = float(ref.mean() - query.mean())
        u = 3.0 * np.sin(yy / 5.0) + 20.0 * d
        v = 2.0 * np.cos(xx / 7.0) - 10.0 * d
        return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("est", ["zero", "analytic"])
def test_window_flows_match_jax(est):
    """(F, R, h, w, 2) at latent resolution, rows below num_ref zero.
    Tolerance 1e-5 (the same resize)."""
    rs = np.random.RandomState(4)
    frames = np.clip(rs.randn(6, 32, 40, 3) * 0.4, -1, 1).astype(np.float32)
    pick = {"zero": (tflow.ZeroFlow(), jflow.ZeroFlow()),
            "analytic": (AnalyticFlow(), AnalyticFlow())}[est]
    got = tflow.window_flows(pick[0], frames, 2, (4, 5)).numpy()
    want = jflow.window_flows(pick[1], frames, 2, (4, 5))
    assert got.shape == (6, 2, 4, 5, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[:2].any()


# --- the flow branch of the window sampler -------------------------------------


def _probe_unet_pair():
    """A linear fake UNet in both packages: the sampler's arithmetic alone."""
    def jprobe(params, sample, t, ctx, vsi):
        lat, cond = jnp.split(sample, 2, axis=-1)
        return 0.7 * lat + 0.1 * cond + jnp.mean(ctx, axis=(1, 2)).reshape(-1, 1, 1, 1, 1)

    def tprobe(sample, t, ctx, vsi):
        lat, cond = sample.chunk(2, dim=-1)
        return 0.7 * lat + 0.1 * cond + ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1, 1)

    return jprobe, tprobe


def _window_inputs(b=1, f=6, r=2, h=5, w=7, seed=5):
    rs = np.random.RandomState(seed)
    lat, cond = (rs.randn(b, f, h, w, 4).astype(np.float32) for _ in range(2))
    tc, tu = (rs.randn(b, 3, 8).astype(np.float32) for _ in range(2))
    ref = np.concatenate([rs.randn(b, r, h, w, 4), np.zeros((b, f - r, h, w, 4))], 1)
    flows = np.zeros((f, r, h, w, 2), np.float32)
    flows[r:] = leaving_flow(rs, (f - r) * r, h, w, scale=1.5).reshape(f - r, r, h, w, 2)
    masks = np.asarray(jax.vmap(lambda fl: jresize.warp_image(jnp.ones((r, h, w, 1)), fl))(
        jnp.asarray(flows)))
    return lat, cond, tc, tu, ref.astype(np.float32), flows, masks


def test_flow_window_matches_jax():
    """A DDPM follow-up window with 2 refs, flows that leave the latent and
    their warped masks, the JAX run's step noise injected; correction for
    the first ceil(0.5 * 4) = 2 steps. Tolerance 2e-4."""
    jprobe, tprobe = _probe_unet_pair()
    lat, cond, tc, tu, ref, flows, masks = _window_inputs()
    steps, rng = 4, jax.random.PRNGKey(9)
    kw = dict(text_cfg=7.5, img_cfg=1.2, num_ref_frames=2, noise_correct_step=0.5)
    want = jsamp.sample_video_window(
        jprobe, None, jsched.make_sampler_tables(jsched.DiffusionSchedule.create(), steps,
                                                 kind="ddpm"),
        jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(tc), jnp.asarray(tu), rng,
        latent_ref=jnp.asarray(ref), flows=jnp.asarray(flows), flow_masks=jnp.asarray(masks),
        **kw)["latent"]
    noises, key = [], rng
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nkey, lat.shape, dtype=jnp.float32)))
    got = tsamp.sample_video_window(
        tprobe, tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), steps, kind="ddpm"),
        np_t(lat), np_t(cond), np_t(tc), np_t(tu), latent_ref=np_t(ref), flows=np_t(flows),
        flow_masks=np_t(masks), step_noise=lambda i, s: torch.tensor(noises[i]), **kw)["latent"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def _port_window(lat, cond, tc, tu, ref, flows=None, masks=None, steps=3):
    _, tprobe = _probe_unet_pair()
    gen = torch.Generator().manual_seed(0)
    return tsamp.sample_video_window(
        tprobe, tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), steps, kind="ddpm"),
        np_t(lat), np_t(cond), np_t(tc), np_t(tu), latent_ref=np_t(ref),
        flows=None if flows is None else np_t(flows),
        flow_masks=None if masks is None else np_t(masks), num_ref_frames=2,
        noise_correct_step=1.0, share_batch_noise=True,
        step_noise=lambda i, s: torch.randn(s, generator=gen))["latent"]


def test_zero_flow_equals_mean_delta():
    """Zero flows with full masks spread the refs' mean delta, as the branch
    without flows does. Tolerance 1e-5."""
    lat, cond, tc, tu, ref, flows, _ = _window_inputs()
    zero, full = np.zeros_like(flows), np.ones(flows.shape[:-1] + (1,), np.float32)
    np.testing.assert_allclose(_port_window(lat, cond, tc, tu, ref, zero, full).numpy(),
                               _port_window(lat, cond, tc, tu, ref).numpy(), atol=1e-5)


def test_flow_window_batch_equals_solo_calls():
    """Two batch elements (different text) with one shared flow stack and
    shared step noise equal two solo calls: each element's deltas are
    warped on their own. Tolerance 1e-5."""
    lat, cond, tc, tu, ref, flows, masks = _window_inputs(b=2)
    lat, cond, ref = lat[:1].repeat(2, 0), cond[:1].repeat(2, 0), ref[:1].repeat(2, 0)
    both = _port_window(lat, cond, tc, tu, ref, flows, masks).numpy()
    for k in range(2):
        s = slice(k, k + 1)
        solo = _port_window(lat[s], cond[s], tc[s], tu[s], ref[s], flows, masks).numpy()
        np.testing.assert_allclose(both[s], solo, atol=1e-5)
    assert np.abs(both[0] - both[1]).max() > 1e-3


# --- the motion-compensated edit ------------------------------------------------


def test_two_window_flow_edit_matches_jax_editor():
    """10 frames at 32x32 in 6-frame windows with 2 refs: the second window
    takes the flows of AnalyticFlow (passed to both editors) from its
    query frames to its refs, at latent resolution, and their warped
    masks. DDIM 3 steps, float32 on both sides, the JAX run's normals
    replayed. Tolerance 2e-4 on frames in [-1, 1], as for the edit
    without flow."""
    (unet, vae, clip), params = tiny_models()
    tok = TinyTokenizer()
    rs = np.random.RandomState(0)
    frames = np.clip(rs.randn(10, 32, 32, 3) * 0.3, -1, 1).astype(np.float32)
    kw = dict(frames_per_window=6, num_ref_frames=2, noise_correct_step=0.7, seed=3,
              use_motion_compensation=True, flow_estimator=AnalyticFlow())
    jed = JEditor(JUNet(cfg=JUNetCfg.tiny()), JVae(cfg=JVaeCfg(**VAE_KW)),
                  JClip(JClipCfg(**CLIP_KW)), params, tokenizer=tok, scheduler="ddim",
                  num_steps=3, params_dtype=None)
    want = np.asarray(jed(frames, "make it snowy", **kw))
    ted = VideoEditor(unet, vae, clip, tokenizer=tok, scheduler="ddim", num_steps=3,
                      device="cpu", dtype=torch.float32)
    timings = {}
    got = ted(frames, "make it snowy", noise=ReplayNoise(jax_editor_normals(3, 10, 6, 2, (16, 16))),
              timings=timings, **kw)
    assert got.shape == frames.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert {"flows_1", "window_1"} <= set(timings) and "flows_0" not in timings
    # the flow changed the edit: without it the second window differs
    plain = ted(frames, "make it snowy", noise=ReplayNoise(jax_editor_normals(3, 10, 6, 2, (16, 16))),
                **dict(kw, use_motion_compensation=False))
    assert np.abs(plain[6:] - got[6:]).max() > 1e-4


def test_convex_upsample_mask_order_against_princeton_vl():
    """The mask's channel order, pinned: the port reads channel
    ``(u*8 + v)*9 + n`` as the JAX function does, where princeton-vl's
    ``upsample_flow`` (the test oracle) reads ``n*64 + u*8 + v``. The two
    agree, to 1e-5, once the mask's channels are permuted; unpermuted they
    differ by more than the flow itself (a pretrained mask head would need
    the permutation)."""
    from oracles.raft_oracle import OracleRAFT

    rs = np.random.RandomState(6)
    flow = rs.randn(1, 3, 4, 2).astype(np.float32)
    mask = (rs.randn(1, 3, 4, 576) * 3).astype(np.float32)
    got = traft.convex_upsample(np_t(flow), np_t(mask)).numpy()
    nchw = lambda a: np_t(a).permute(0, 3, 1, 2)
    oracle = lambda m: OracleRAFT.upsample_flow(None, nchw(flow), nchw(m)).permute(0, 2, 3, 1)
    permuted = mask.reshape(1, 3, 4, 64, 9).transpose(0, 1, 2, 4, 3).reshape(1, 3, 4, 576)
    np.testing.assert_allclose(got, oracle(permuted).numpy(), atol=1e-5)
    assert np.abs(got - oracle(mask).numpy()).max() > np.abs(got).max()


@pytest.mark.parametrize("order", ["reference", "princeton-vl"])
def test_load_raft_state_dict_mask_order(order):
    """``load_raft_state_dict(mask_order=)``: a checkpoint whose mask head
    gives princeton-vl's channel order, loaded with ``"princeton-vl"``,
    upsamples as princeton-vl's ``upsample_flow`` (the oracle) does on that
    checkpoint's own mask, to 1e-5; the default loads the weights as they
    are (the order the JAX package reads) and then differs from it."""
    from oracles.raft_oracle import OracleRAFT

    cfg = traft.RaftConfig.tiny()
    sd = seeded_raft(cfg).state_dict()
    model = traft.RAFT(cfg).eval()
    load_raft_state_dict(model, sd, mask_order=order)
    as_is = traft.RAFT(cfg).eval()
    load_raft_state_dict(as_is, sd)
    for k, v in sd.items():
        if order == "reference" or not k.startswith("update_block.mask.2."):
            np.testing.assert_array_equal(model.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    rs = np.random.RandomState(8)
    h = np_t(rs.randn(1, cfg.hidden_dim, 3, 4).astype(np.float32) * 2)
    flow = np_t(rs.randn(1, 2, 3, 4).astype(np.float32))
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    with torch.no_grad():
        want = nhwc(OracleRAFT.upsample_flow(None, flow, as_is.update_block.upsample_mask(h)))
        got = traft.convex_upsample(nhwc(flow), nhwc(model.update_block.upsample_mask(h)))
    if order == "princeton-vl":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    else:
        assert (got - want).abs().max() > 1e-2
    with pytest.raises(ValueError, match="mask_order"):
        load_raft_state_dict(model, sd, mask_order="unknown")
