"""The port's T5 v1.1 encoder, ``ClassEmbedder`` and ``ClipT5Encoder``
(insv2v_torch.models.t5_text) against the JAX package's and HF's.

Tolerances: 1e-5 against the JAX ``T5TextEncoder`` (weights carried over by
``torch_state_dict_from_flax(kind="t5")``) and against HF
``T5EncoderModel`` (its own ``state_dict()`` loaded as it is), float32 on
the CPU at the tiny config; the bucket function exactly; a bf16 encoder
against the JAX bf16 encoder at 2e-2 relative L2 (bf16 rounding through
two blocks), both returning float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.models import t5_text as jt5
from insv2v_tpu.utils.convert import convert_t5_state_dict
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.t5_text import (ClassEmbedder, ClipT5Encoder, T5Config, T5TextEncoder,
                                         build_clip_t5_encoder, build_t5_encoder,
                                         relative_position_bucket)
from insv2v_torch.utils.convert import flatten, torch_state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs, as the other
    port test modules do: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ids(b=2, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, 77)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_t5():
    """The JAX tiny encoder's params from a Flax init, with the bias table
    scaled up so that the relative positions matter."""
    model = jt5.T5TextEncoder(jt5.T5Config.tiny())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["relative_attention_bias"]["embedding"] = \
        params["relative_attention_bias"]["embedding"] * 4.0
    return model, params


def port_from(params, dtype=torch.float32):
    port = T5TextEncoder(T5Config.tiny())
    port.load_state_dict(torch_state_dict_from_flax(params, "t5"))
    return port.to(dtype).eval()


def test_t5_matches_jax(jax_t5):
    model, params = jax_t5
    x = ids()
    want = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port_from(params)(torch.from_numpy(x))
    assert got.shape == (2, 77, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_t5_weight_bridge_round_trip(jax_t5):
    _, params = jax_t5
    back = convert_t5_state_dict(port_from(params).state_dict())
    fb, fp = flatten(back), flatten(params)
    assert set(fb) == set(fp)
    for k in fp:
        np.testing.assert_array_equal(np.asarray(fb[k]), fp[k], err_msg=str(k))


def test_t5_bf16_returns_float32_as_jax_does(jax_t5):
    """The RMSNorm's float32 output (the JAX package's dtype, not HF's)."""
    _, params = jax_t5
    x = ids(seed=1)
    want = jt5.T5TextEncoder(jt5.T5Config.tiny(), dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port_from(params, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 2e-2


def test_t5_loads_and_matches_hf_t5_encoder_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(
        vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        feed_forward_proj="gated-gelu", dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(cfg).eval()
    port = T5TextEncoder(T5Config.tiny())
    sd = hf.state_dict()
    assert "encoder.embed_tokens.weight" in sd and set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    x = torch.from_numpy(ids(seed=2)).long()
    with torch.no_grad():
        want = hf(input_ids=x).last_hidden_state
        got = port.eval()(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_relative_position_bucket_matches_jax_exactly():
    rel = np.arange(-300, 301).reshape(1, -1)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel)))
    got = relative_position_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)
    # the (L, L) table the encoder builds, at another bucketing
    pos = np.arange(77)
    grid = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        relative_position_bucket(torch.from_numpy(grid), 16, 64).numpy(),
        np.asarray(jt5.relative_position_bucket(jnp.asarray(grid), 16, 64)))


# --- ClassEmbedder ---------------------------------------------------------------

def test_class_embedder_matches_jax():
    jemb = jt5.ClassEmbedder(embed_dim=8, n_classes=10, ucg_rate=0.1)
    c = jnp.array([0, 3, 9, 5])
    params = jax.tree_util.tree_map(
        np.asarray, jemb.init(jax.random.PRNGKey(0), c, disable_dropout=True)["params"])
    want = jemb.apply({"params": params}, c, disable_dropout=True)
    emb = ClassEmbedder(8, n_classes=10, ucg_rate=0.1)
    emb.load_state_dict(torch_state_dict_from_flax(params, "class_embedder"))
    with torch.no_grad():
        got = emb(torch.tensor([0, 3, 9, 5]), disable_dropout=True)
    assert got.shape == (4, 1, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_class_embedder_ucg_dropout():
    ids_ = torch.tensor([0, 1, 2, 3, 4, 5])
    gen = torch.Generator().manual_seed(0)
    always = ClassEmbedder(8, n_classes=10, ucg_rate=1.0)
    never = ClassEmbedder(8, n_classes=10, ucg_rate=0.0)
    never.load_state_dict(always.state_dict())
    with torch.no_grad():
        uncond = always(always.unconditional_ids(6), disable_dropout=True)
        torch.testing.assert_close(always(ids_, generator=gen), uncond, atol=0, rtol=0)
        plain = always(ids_, disable_dropout=True)
        torch.testing.assert_close(never(ids_), plain, atol=0, rtol=0)
        assert not torch.equal(plain, uncond)
    assert always.unconditional_ids(3).tolist() == [9, 9, 9]
    with pytest.raises(ValueError, match="generator"):
        always(ids_)
    # a rate in between drops a seeded share, the same share for the same seed
    half = ClassEmbedder(8, n_classes=1000, ucg_rate=0.5)
    many = torch.arange(400)
    draw = lambda: half(many, generator=torch.Generator().manual_seed(3))
    dropped = (draw() == half(half.unconditional_ids(400), disable_dropout=True)).all(-1)
    assert 120 < int(dropped.sum()) < 280
    torch.testing.assert_close(draw(), draw(), atol=0, rtol=0)


# --- ClipT5Encoder and the build functions ------------------------------------

def test_clip_t5_encoder_returns_both_encoders_outputs():
    clip = ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=12, num_layers=1,
                                          num_heads=2, intermediate_size=24)).eval()
    t5 = T5TextEncoder(T5Config.tiny()).eval()
    enc = ClipT5Encoder(clip, t5)
    cids, tids = torch.from_numpy(ids(vocab=64)), torch.from_numpy(ids(seed=3))
    with torch.no_grad():
        clip_z, t5_z = enc(cids, tids)
        torch.testing.assert_close(clip_z, clip(cids), atol=0, rtol=0)
        torch.testing.assert_close(t5_z, t5(tids), atol=0, rtol=0)
    assert clip_z.shape == (2, 77, 12) and t5_z.shape == (2, 77, 16)
    keys = set(enc.state_dict())
    assert "clip_encoder.transformer.text_model.final_layer_norm.weight" in keys
    assert "t5_encoder.transformer.encoder.block.1.layer.1.DenseReluDense.wo.weight" in keys


def test_build_functions_resolve_the_device():
    t5 = build_t5_encoder(T5Config.tiny(), device="cpu", dtype=torch.float32)
    assert next(t5.parameters()).device.type == "cpu" and not t5.training
    enc = build_clip_t5_encoder(ClipTextConfig(vocab_size=64, hidden_size=12, num_layers=1,
                                               num_heads=2, intermediate_size=24),
                                T5Config.tiny(), device="cpu", dtype=torch.float32)
    assert isinstance(enc, ClipT5Encoder)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_t5_encoder(T5Config.tiny())
