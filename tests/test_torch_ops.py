"""Parity of the port's kernel-free ops (insv2v_torch.ops) with the JAX
package's: the same numpy inputs through both, float32 on the CPU.

Tolerance 1e-5 absolute unless stated: both sides compute the same
float32 formula and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.ops import embeddings as jemb
from insv2v_tpu.ops import norms as jnorms
from insv2v_tpu.ops.resize import nearest_upsample_2x as j_up
from insv2v_torch.ops import embeddings as temb
from insv2v_torch.ops import norms as tnorms
from insv2v_torch.ops.resize import nearest_upsample_2x as t_up

RS = np.random.RandomState(0)


def _affine(c):
    return (1.0 + 0.1 * RS.randn(c)).astype(np.float32), (0.1 * RS.randn(c)).astype(np.float32)


@pytest.mark.parametrize("shape,axes,groups,eps", [
    ((2, 3, 4, 5, 8), None, 4, 1e-5),          # ResnetBlock3D: pooled across frames
    ((6, 4, 5, 8), None, 2, 1e-6),             # transformer/motion: frames in batch
    ((2, 3, 4, 5, 8), (2, 3), 4, 1e-6),        # explicit per-frame axes
])
def test_group_norm(shape, axes, groups, eps):
    x = (RS.randn(*shape) * 2 + 0.5).astype(np.float32)
    s, b = _affine(shape[-1])
    want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups, eps,
                             reduce_axes=axes)
    got = tnorms.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b),
                            groups, eps, reduce_axes=axes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_group_norm_across_frames_differs_from_per_frame():
    """The axes choice matters: pooled statistics are not per-frame ones."""
    x = torch.from_numpy((RS.randn(1, 3, 4, 4, 8) * np.arange(1, 4)[None, :, None, None, None]
                          ).astype(np.float32))
    one, zero = torch.ones(8), torch.zeros(8)
    pooled = tnorms.group_norm(x, one, zero, 4)
    per_frame = tnorms.group_norm(x.reshape(3, 4, 4, 8), one, zero, 4).reshape(x.shape)
    assert (pooled - per_frame).abs().max() > 0.1


def test_layer_norm():
    x = (RS.randn(3, 7, 16) * 3 + 1).astype(np.float32)
    s, b = _affine(16)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0), (9, False, 1)])
def test_timestep_embedding(dim, flip, shift):
    # tolerance 2e-4: sin/cos of arguments up to ~1000 in float32, where one
    # ulp of the argument is ~6e-5
    t = np.array([0, 1, 321, 999], dtype=np.int32)
    want = jemb.timestep_embedding(jnp.asarray(t), dim, flip, shift)
    got = temb.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_positional_encoding_table_is_the_same_table():
    np.testing.assert_array_equal(temb.temporal_positional_encoding_table(40, 32),
                                  jemb.temporal_positional_encoding_table(40, 32))


@pytest.mark.parametrize("start,frames", [(0, 16), (12, 16), (16, 16), (20, 16), (31, 1)])
def test_temporal_pe_slice_including_wraparound(start, frames):
    table = temb.temporal_positional_encoding_table(8, 32)
    want = jemb.temporal_pe_slice(jnp.asarray(table), start, frames)
    got = temb.temporal_pe_slice(torch.from_numpy(table), start, frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nearest_upsample_2x():
    x = RS.randn(2, 3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(t_up(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_up(jnp.asarray(x))))
