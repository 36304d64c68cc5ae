"""The port's split-skip up-block path (``INSV2V_SPLIT_SKIP``): the up blocks
consume their skip without building ``concat([x, skip], -1)``.

``ops.norms.group_norm_split_pair`` against the JAX package's function on a
group that straddles the two parts (1e-5); the tiny port UNet's split path
against its concat path (the JAX test's tolerance, tests/test_unet3d.py:
atol 2e-5, rtol 1e-5) with the same parameters, and against the JAX UNet on
its split path with the weights carried over by the converter (1e-4, the
UNet parity tolerance of tests/test_torch_models.py); which calls take the
path; the trainer's pin to the concat path; and the split GroupNorm with
its frames sharded over two gloo ranks on the CPU against the unsharded
one (1e-5), where dropping its all-reduce must fail the comparison.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.models.unet3d import UNet3DConditionModel as JUNet
from insv2v_tpu.models.unet3d import UNetConfig as JUNetCfg
from insv2v_tpu.ops.norms import group_norm_split_pair as jax_split_pair
from insv2v_torch.models import unet3d
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig, uses_split_skip
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import norms
from insv2v_torch.ops.norms import group_norm, group_norm_split_pair
from insv2v_torch.parallel import dist as pdist
from insv2v_torch.training.trainer import Trainer
from test_torch_diffusion import tiny_unet_pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs, as the other
    port test modules do: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair_inputs(seed=0, shape=(2, 3, 4, 5), c1=6, c2=10, offset=1.5):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape, c1) * 2.0 + offset).astype(np.float32)
    skip = (rs.randn(*shape, c2) * 0.5 - offset).astype(np.float32)
    scale = rs.randn(c1 + c2).astype(np.float32)
    bias = rs.randn(c1 + c2).astype(np.float32)
    return x, skip, scale, bias


# --- group_norm_split_pair -------------------------------------------------------

@pytest.mark.parametrize("c1,c2,groups", [(6, 10, 4), (12, 4, 4), (8, 8, 2)])
def test_split_pair_matches_jax(c1, c2, groups):
    """6 + 10 channels in 4 groups of 4: group 1 holds channels 4-7, two of
    each part."""
    x, skip, scale, bias = pair_inputs(c1=c1, c2=c2)
    jx, js = jax_split_pair(jnp.asarray(x), jnp.asarray(skip), jnp.asarray(scale),
                            jnp.asarray(bias), groups, 1e-5)
    tx, ts = group_norm_split_pair(torch.from_numpy(x), torch.from_numpy(skip),
                                   torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_split_pair_equals_group_norm_of_the_concat_and_keeps_each_dtype():
    x, skip, scale, bias = (torch.from_numpy(a) for a in pair_inputs(seed=1))
    want = group_norm(torch.cat([x, skip], -1), scale, bias, 4, 1e-5)
    xn, sn = group_norm_split_pair(x, skip, scale, bias, 4, 1e-5)
    torch.testing.assert_close(torch.cat([xn, sn], -1), want, atol=1e-5, rtol=0)
    xn, sn = group_norm_split_pair(x.bfloat16(), skip, scale, bias, 4, 1e-5)
    assert xn.dtype == torch.bfloat16 and sn.dtype == torch.float32


# --- the tiny UNet ---------------------------------------------------------------

def unet_inputs(b, seed=2):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(b, 2, 8, 8, 8).astype(np.float32)),
            torch.from_numpy(rs.randint(0, 1000, b)),
            torch.from_numpy(rs.randn(b, 3, 12).astype(np.float32)))


def with_split(port, split):
    other = UNet3DConditionModel(dataclasses.replace(port.cfg, split_skip=split))
    other.load_state_dict(port.state_dict())
    return other.eval()


def test_unet_split_path_matches_concat_path():
    port, _ = tiny_unet_pair(seed=5)
    split, concat = with_split(port, True), with_split(port, False)
    assert list(split.state_dict()) == list(concat.state_dict())
    args = unet_inputs(2)
    with torch.no_grad():
        got, want = split(*args, video_start_index=1), concat(*args, video_start_index=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


def test_unet_split_path_matches_jax_split_path():
    """The JAX UNet at batch 2 takes its split path by default (batch <= 3)."""
    port, params = tiny_unet_pair(seed=6)
    split = with_split(port, True)
    x, t, ctx = unet_inputs(2, seed=3)
    apply = jax.jit(lambda p, x, t, c: JUNet(cfg=JUNetCfg.tiny()).apply(
        {"params": p}, x, t, c, video_start_index=2))
    want = apply(params, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
                 jnp.asarray(ctx.numpy()))
    with torch.no_grad():
        got = split(x, t, ctx, video_start_index=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_split_path_follows_reloaded_weights_and_carries_gradients():
    """The channels-last kernel slices the split path keeps between calls
    follow a ``load_state_dict`` and an in-place update; under autograd the
    path takes fresh slices, and conv1's gradient equals the concat
    path's."""
    port, _ = tiny_unet_pair(seed=5)
    other, _ = tiny_unet_pair(seed=8)
    split, concat = with_split(port, True), with_split(other, False)
    args = unet_inputs(1, seed=4)
    with torch.no_grad():
        split(*args)  # keeps the slices of port's weights
        split.load_state_dict(other.state_dict())
        np.testing.assert_allclose(split(*args).numpy(), concat(*args).numpy(), atol=2e-5,
                                   rtol=1e-5)
        for m in (split, concat):
            m.up_blocks[1].resnets[2].conv1.weight.mul_(1.5)
        np.testing.assert_allclose(split(*args).numpy(), concat(*args).numpy(), atol=2e-5,
                                   rtol=1e-5)
    grads = []
    for m in (split, concat):
        m.zero_grad()
        (m(*args) ** 2).sum().backward()
        grads.append(m.up_blocks[1].resnets[2].conv1.weight.grad)
    assert grads[0] is not None and grads[0].abs().sum() > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch,config,expected", [
    (3, None, True), (4, None, False), (1, False, False), (6, True, False)])
def test_which_calls_take_the_split_path(monkeypatch, batch, config, expected):
    """The JAX rule: the switch (or ``cfg.split_skip``) and at most
    SPLIT_SKIP_MAX_B = 3 videos; counted by the split GroupNorm's calls."""
    calls = []
    monkeypatch.setattr(unet3d, "group_norm_split_pair",
                        lambda *a, **k: calls.append(1) or group_norm_split_pair(*a, **k))
    port, _ = tiny_unet_pair()
    port = with_split(port, config)
    assert uses_split_skip(port.cfg, batch) is expected
    with torch.no_grad():
        port(*unet_inputs(batch))
    assert bool(calls) is expected
    # 4 up blocks of 3 resnets, each taking one skip
    assert len(calls) == (12 if expected else 0)


def test_switch_off_takes_the_concat_path(monkeypatch):
    monkeypatch.setattr(unet3d, "SPLIT_SKIP", False)
    assert not uses_split_skip(UNetConfig.tiny(), 1)
    assert uses_split_skip(UNetConfig.tiny(split_skip=True), 1)


def test_trainer_calls_take_the_concat_path(monkeypatch):
    """As the JAX trainer's (tests/test_trainer.py), for the trainer's own
    calls: the model it trains keeps the switch's default for inference."""
    calls = []
    monkeypatch.setattr(unet3d, "group_norm_split_pair",
                        lambda *a, **k: calls.append(1) or group_norm_split_pair(*a, **k))
    torch.manual_seed(0)
    unet = UNet3DConditionModel(UNetConfig.tiny())
    vae = AutoencoderKL(VaeConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                                  embed_dim=4, resolution=16))
    text = ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=12, num_layers=1,
                                          num_heads=2, intermediate_size=24))
    trainer = Trainer(unet, vae, text)
    rs = np.random.RandomState(0)
    micro = {"input_video": rs.uniform(-1, 1, (1, 2, 16, 16, 3)).astype(np.float32),
             "edited_video": rs.uniform(-1, 1, (1, 2, 16, 16, 3)).astype(np.float32),
             "prompt_ids": rs.randint(0, 64, (1, 77))}
    loss = trainer.microbatch_loss(micro, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and not calls
    assert unet.cfg.split_skip is None and uses_split_skip(unet.cfg, 1)
    assert not uses_split_skip(unet.cfg, 1, split_skip=False)
    with torch.no_grad():
        unet(*unet_inputs(1))
    assert len(calls) == 12  # the same model, called for inference


# --- frames sharded over two gloo ranks ----------------------------------------

RANKS = 2


@contextlib.contextmanager
def _dropped_all_reduce(dropped):
    """The planted fault, when ``dropped``: every sharded GroupNorm's
    statistics from this rank's own frames."""
    saved = norms._sum_over_ranks
    if dropped:
        norms._sum_over_ranks = lambda moments, _group: moments
    try:
        yield
    finally:
        norms._sum_over_ranks = saved


def _rank(group, pair, sd, call):
    torch.set_num_threads(1)
    x, skip, scale, bias = (torch.from_numpy(a) for a in pair)
    frames = pdist.shard_range(x.shape[1], group.rank, group.size)
    unet = UNet3DConditionModel(UNetConfig.tiny(split_skip=True))
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    unet.eval()
    sample, t, ctx = (torch.from_numpy(a) for a in call)
    out = {}
    for name, dropped in (("sharded", False), ("dropped", True)):
        with _dropped_all_reduce(dropped), torch.no_grad():
            xn, sn = group_norm_split_pair(x[:, frames], skip[:, frames], scale, bias, 4, 1e-5,
                                           group=group)
            with pdist.frame_parallel(group):
                eps = unet(sample[:, pdist.shard_range(sample.shape[1], group.rank, group.size)],
                           t, ctx, video_start_index=1)
        out[name] = {"pair": [group.all_gather_dim(p, 1).numpy() for p in (xn, sn)],
                     "unet": group.all_gather_dim(eps, 1).numpy()}
    return out


@pytest.fixture(scope="module")
def sharded():
    """6 frames over 2 ranks, whose means drift over the frames as a
    video's do: the split pair alone, and one call of the tiny UNet on its
    split path (batch 1, 4 frames a rank) inside ``frame_parallel``."""
    x, skip, scale, bias = pair_inputs(seed=4, shape=(2, 6, 4, 3))
    ramp = np.linspace(-2, 2, 6, dtype=np.float32).reshape(1, 6, 1, 1, 1)
    pair = (x + ramp, skip * (1 + 0.5 * ramp), scale, bias)
    want_pair = group_norm_split_pair(*(torch.from_numpy(a) for a in pair), 4, 1e-5)
    port, _ = tiny_unet_pair(seed=7)
    port = with_split(port, True)
    rs = np.random.RandomState(5)
    ramp = np.linspace(-1, 1, 8, dtype=np.float32).reshape(1, 8, 1, 1, 1)
    sample = (rs.randn(1, 8, 8, 8, 8) * (1 + 0.5 * ramp) + ramp).astype(np.float32)
    call = (sample, np.array([400]), rs.randn(1, 3, 12).astype(np.float32))
    with torch.no_grad():
        want_unet = port(*(torch.from_numpy(a) for a in call), video_start_index=1).numpy()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    ranks = pdist.spawn(_rank, RANKS, pair, sd, call, timeout_s=240)
    return {"pair": [w.numpy() for w in want_pair], "unet": want_unet}, ranks


def test_frame_sharded_split_path_equals_the_unsharded(sharded):
    want, ranks = sharded
    for out in ranks:
        for got, ref in zip(out["sharded"]["pair"], want["pair"]):
            np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(out["sharded"]["unet"], want["unet"], atol=1e-4)


def test_frame_sharded_split_path_without_its_all_reduce_fails(sharded):
    want, ranks = sharded
    for out in ranks:
        pair_err = max(np.abs(got - ref).max()
                       for got, ref in zip(out["dropped"]["pair"], want["pair"]))
        unet_err = np.abs(out["dropped"]["unet"] - want["unet"]).max()
        assert pair_err > 1e-2 and unet_err > 1e-3, (pair_err, unet_err)
