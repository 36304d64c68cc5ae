"""Kernels C and A of the port at the shapes their CUDA designs take apart:
the plain twins against the JAX package's Pallas kernels (interpret mode)
and XLA references on the CPU.

Kernel C's CUDA kernel pads frames to 16 or 32 and the head width to a
multiple of 16 in its fragments, and splits a pixel's heads into work
units; kernel A's d = 64 body takes 128-row query items and 128-key
tiles. The twins these cases hold to the JAX package are what the CUDA
kernels are held to on the card (tests/test_torch_gpu_kernels.py).

Inputs are made with numpy from a seed and go through both packages in
float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.ops import attention as jattn
from insv2v_torch.ops import attention as tattn


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs (the suite's
    parallel workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("heads", [1, 8])
@pytest.mark.parametrize("e", [40, 80, 160])
@pytest.mark.parametrize("f", [1, 16, 17, 32])
def test_temporal_twin_matches_packed_kernel_at_motion_shapes(f, e, heads):
    """The motion modules' head widths (40, 80, 160) at one and eight
    heads, one frame, 16 (the edit's window), 17 (one past the 16-frame
    tile) and 32 (the most the kernel takes). b = 1, p = 3 pixels.
    Tolerance 2e-5: float32, masked softmax over m = F*heads against the
    softmax over F."""
    b, p = 1, 3
    q, k, v = (rnd(b, p, f, heads, e, seed=s) for s in (7, 8, 9))
    got = tattn.temporal_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v))).numpy()
    pack = lambda t: jnp.asarray(t.reshape(b, p, f * heads, e))
    unpack = lambda t: np.asarray(t).reshape(b, p, f, heads, e)
    xla = jattn.packed_temporal_attention_xla(pack(q), pack(k), pack(v), heads)
    np.testing.assert_allclose(got, unpack(xla), atol=2e-5)
    pallas = jattn.packed_temporal_attention(pack(q), pack(k), pack(v), heads,
                                             blk_p=p, interpret=True)
    np.testing.assert_allclose(got, unpack(pallas), atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 260)])
def test_flash_twin_matches_pallas_flash_at_d64(sq, sk):
    """ModelScope's head width: S = 256 (two whole 128-row items of the
    CUDA body) and a ragged pair (neither a multiple of 128, sq != sk).
    Tolerance 2e-5: float32 online softmax against one-shot softmax."""
    q, k, v = rnd(2, 3, sq, 64, seed=10), rnd(2, 3, sk, 64, seed=11), rnd(2, 3, sk, 64, seed=12)
    got = tattn.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v)).numpy()
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   blk_q=128, blk_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    plain = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-5)
