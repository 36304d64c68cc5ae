"""The port's data-generation models against the JAX package, float32 on the
CPU at tiny sizes: ModelScope's UNetSD (plain context, the (key, value)
tuple context and the prompt-to-prompt ``sa_share`` batch) and the
OpenCLIP text tower, on one weight set shared through the converters; the
two converter kinds round trip; UNetSD loads the reference-layout torch
oracle's state dict strictly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.models.modelscope_t2v import ModelScopeConfig as JMsCfg
from insv2v_tpu.models.modelscope_t2v import UNetSD as JUNetSD
from insv2v_tpu.models.openclip_text import OpenClipTextConfig as JOcCfg
from insv2v_tpu.models.openclip_text import OpenClipTextEncoder as JOc
from insv2v_tpu.utils.convert import (convert_openclip_text_state_dict,
                                      convert_unet_sd_state_dict)
from insv2v_torch.models.modelscope_t2v import ModelScopeConfig, UNetSD, sinusoidal_embedding
from insv2v_torch.models.openclip_text import (OpenClipTextConfig, OpenClipTextEncoder,
                                               openclip_text_state_dict)
from insv2v_torch.utils.convert import torch_state_dict_from_flax
from oracles.unet_sd_oracle import OracleUNetSD

CFG, JCFG = ModelScopeConfig.tiny(context_dim=12), JMsCfg.tiny(context_dim=12)
OC_KW = dict(vocab_size=120, width=16, num_layers=2, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def oracle():
    """The reference-layout torch oracle, its zero-initialised heads (the
    conv4s, the out convs, the transformers' proj_out) made random so every
    path counts."""
    torch.manual_seed(0)
    model = OracleUNetSD()
    with torch.no_grad():
        for p in model.parameters():
            if p.abs().max() == 0:
                p.copy_(torch.randn_like(p) * 0.05)
    return model.eval()


@pytest.fixture(scope="module")
def flax_params(oracle):
    return convert_unet_sd_state_dict(oracle.state_dict(), JCFG)


def port_unet(params):
    model = UNetSD(CFG).eval()
    model.load_state_dict(torch_state_dict_from_flax(params, "unet_sd", CFG), strict=True)
    return model


def test_sinusoidal_embedding_matches_jax():
    from insv2v_tpu.models.modelscope_t2v import sinusoidal_embedding as jsin

    t = np.array([0, 1, 321, 999])
    np.testing.assert_allclose(sinusoidal_embedding(torch.from_numpy(t), 16).numpy(),
                               np.asarray(jsin(jnp.asarray(t), 16)), atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "kv_tuple", "sa_share"])
def test_unet_sd_matches_jax(flax_params, case):
    """One UNetSD call on the same weights: a plain context (1 x 2 frames),
    a (key, value) tuple (1 x 2 frames) and the 4-way prompt-to-prompt
    batch with ``sa_share`` (4 x 1 frame), 8x8 latents. Tolerance 5e-4,
    the JAX package's own UNetSD-against-oracle tolerance."""
    rs = np.random.RandomState({"plain": 0, "kv_tuple": 1, "sa_share": 2}[case])
    b, f = (4, 1) if case == "sa_share" else (1, 2)
    x = rs.randn(b, f, 8, 8, 4).astype(np.float32)
    t = np.full((b,), 321, dtype=np.int64)
    ctx = rs.randn(b, 5, 12).astype(np.float32)
    if case == "kv_tuple":
        jctx = (jnp.asarray(ctx), jnp.asarray(rs.randn(b, 5, 12).astype(np.float32)))
    else:
        jctx = jnp.asarray(ctx)
    share = case == "sa_share"
    want = np.asarray(JUNetSD(cfg=JCFG).apply({"params": flax_params}, jnp.asarray(x),
                                              jnp.asarray(t), jctx, sa_share=share))
    tctx = (tuple(torch.from_numpy(np.array(c)) for c in jctx) if case == "kv_tuple"
            else torch.from_numpy(ctx))
    with torch.no_grad():
        got = port_unet(flax_params)(torch.from_numpy(x), torch.from_numpy(t), tctx,
                                     sa_share=share).numpy()
    assert got.shape == (b, f, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_unet_sd_loads_the_oracle_strictly(oracle):
    """The reference's key layout: the oracle's state dict (its temporal
    conv2-4 without the Dropout slot, at ``convN.2``) loads with
    ``strict=True`` and gives the oracle's output (tolerance 5e-4); the
    port's own state dict keeps the reference's ``convN.3``."""
    model = UNetSD(CFG).eval()
    model.load_state_dict(oracle.state_dict(), strict=True)
    assert "input_blocks.1.0.temopral_conv.conv2.3.weight" in model.state_dict()
    assert model.state_dict()["input_blocks.1.0.temopral_conv.conv1.2.weight"].shape == \
        (16, 16, 3, 1, 1)
    assert model.state_dict()["input_blocks.0.1.proj_in.weight"].shape == (16, 16, 1)
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(1, 5, 12).astype(np.float32)
    t = np.array([10], dtype=np.int64)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(t),
                      torch.from_numpy(ctx)).permute(0, 2, 3, 4, 1).numpy()
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_unet_sd_converter_round_trips(flax_params):
    """Flax -> the port's state dict -> ``convert_unet_sd_state_dict``
    gives the Flax tree back exactly, and the port's keys are its
    module's."""
    sd = torch_state_dict_from_flax(flax_params, "unet_sd", CFG)
    assert set(sd) == set(UNetSD(CFG).state_dict())
    back = flax_leaves(convert_unet_sd_state_dict(sd, JCFG))
    want = flax_leaves(flax_params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def openclip_params():
    ids = np.zeros((1, 77), dtype=np.int32)
    params = JOc(JOcCfg(**OC_KW)).init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    rs = np.random.RandomState(4)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(np.float32), params)


def test_openclip_text_matches_jax(openclip_params):
    """Width 16, 2 layers (the penultimate runs 1), 2 heads, 77 tokens: the
    port against Flax on the same weights, tolerance 1e-5. The port holds
    the tower's last block too (so a real checkpoint loads strictly); a
    Flax tree, which has none, leaves only that block unloaded."""
    sd = torch_state_dict_from_flax(openclip_params, "openclip_text")
    model = OpenClipTextEncoder(OpenClipTextConfig(**OC_KW)).eval()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and missing and all(
        k.startswith("transformer.resblocks.1.") for k in missing)
    ids = np.random.RandomState(5).randint(0, 120, (2, 77))
    want = np.asarray(JOc(JOcCfg(**OC_KW)).apply({"params": openclip_params},
                                                 jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_openclip_text_converter_round_trips_and_loads_open_clip_keys(openclip_params):
    """Flax -> the port's (open_clip) keys -> ``convert_openclip_text_state_dict``
    gives the Flax tree back exactly; a whole open_clip model's state dict
    (``model.`` prefix, the visual tower, ``text_projection``,
    ``logit_scale``) loads its text tower strictly."""
    sd = torch_state_dict_from_flax(openclip_params, "openclip_text")
    back = flax_leaves(convert_openclip_text_state_dict(sd))
    want = flax_leaves(openclip_params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    model = OpenClipTextEncoder(OpenClipTextConfig(**OC_KW))
    full = {"model." + k: v for k, v in model.state_dict().items()}
    full.update({"model.visual.proj": torch.zeros(3), "model.text_projection": torch.zeros(2),
                 "model.logit_scale": torch.zeros(())})
    fresh = OpenClipTextEncoder(OpenClipTextConfig(**OC_KW))
    fresh.load_state_dict(openclip_text_state_dict(full), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
