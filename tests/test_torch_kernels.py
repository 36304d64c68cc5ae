"""Kernels A, B and C of the port: their plain twins against the JAX
package's Pallas kernels (interpret mode) and XLA references on the CPU.
The CUDA kernels themselves are held against their twins on the card by
tests/test_torch_gpu_kernels.py.

Inputs are made with numpy from a seed and go through both packages in
float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.ops import attention as jattn
from insv2v_tpu.ops import fused_ff as jff
from insv2v_torch.ops import attention as tattn
from insv2v_torch.ops import fused_ff as tff


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# --- kernel A: flash attention ---------------------------------------------

@pytest.mark.parametrize("sq,sk,d", [(300, 300, 40), (300, 260, 80), (260, 300, 512)])
def test_flash_twin_matches_pallas_flash_and_attention(sq, sk, d):
    """Ragged sequences (300 is no multiple of the 128 blocks) at the UNet
    head dims and the VAE's single 512-wide head. Tolerance 2e-5: float32
    online softmax vs one-shot softmax (the 512-term logit sums of O(1)
    values stay well inside it)."""
    q, k, v = rnd(2, 2, sq, d, seed=1), rnd(2, 2, sk, d, seed=2), rnd(2, 2, sk, d, seed=3)
    got = tattn.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v)).numpy()
    pallas = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   blk_q=128, blk_k=128, interpret=True)
    plain = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-5)


def test_flash_wrapper_takes_the_twin_on_cpu_and_counts_no_launch():
    q = torch.from_numpy(rnd(1, 2, 300, 40))
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, q, q)
    assert tattn.flash_attention.launches == before
    torch.testing.assert_close(out, tattn.attention(q, q, q), rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk,use", [(300, 300, True), (300, 77, False), (96, 96, False)])
def test_dot_attention_dispatch_thresholds(sq, sk, use, monkeypatch):
    """Flash only when Sq and Sk are both >= 256, as in the JAX package."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or tattn.attention(*a, **k))
    q, k = torch.zeros(1, 1, sq, 8), torch.zeros(1, 1, sk, 8)
    tattn.dot_attention(q, k, k)
    assert bool(calls) == use


# --- kernel C: temporal attention -------------------------------------------

@pytest.mark.parametrize("f,heads,e", [(16, 8, 5), (6, 2, 8)])
def test_temporal_twin_matches_packed_kernel_and_xla(f, heads, e):
    """The twin's unpacked per-(pixel, head) form against the JAX packed
    form, which the test builds by striped packing (m = f * heads + h).
    Tolerance 2e-5: float32, masked softmax over m vs softmax over F."""
    b, p = 2, 12
    q, k, v = (rnd(b, p, f, heads, e, seed=s) for s in (4, 5, 6))
    got = tattn.temporal_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v))).numpy()
    pack = lambda t: jnp.asarray(t.reshape(b, p, f * heads, e))
    unpack = lambda t: np.asarray(t).reshape(b, p, f, heads, e)
    xla = jattn.packed_temporal_attention_xla(pack(q), pack(k), pack(v), heads)
    np.testing.assert_allclose(got, unpack(xla), atol=2e-5)
    pallas = jattn.packed_temporal_attention(pack(q), pack(k), pack(v), heads,
                                             blk_p=8, interpret=True)
    np.testing.assert_allclose(got, unpack(pallas), atol=2e-5)


# --- kernel B: fused LN + GEGLU FF + residual --------------------------------

def _ff_args(rows, c, seed=0):
    """Weights at 0.05, or 1/sqrt(fan-in) where that is smaller (C = 1280),
    so that the outputs stay O(1) and one float32 tolerance holds at every
    width."""
    inner = 4 * c
    s1, s2 = min(0.05, c ** -0.5), min(0.05, inner ** -0.5)
    return (rnd(rows, c, seed=seed), 1.0 + rnd(c, seed=seed + 1, scale=0.1),
            rnd(c, seed=seed + 2, scale=0.1), rnd(c, 2 * inner, seed=seed + 3, scale=s1),
            rnd(2 * inner, seed=seed + 4, scale=0.01), rnd(inner, c, seed=seed + 5, scale=s2),
            rnd(c, seed=seed + 6, scale=0.01))


def _torch_ff_args(args):
    """JAX layout (w1 (C, 2*inner), w2 (inner, C)) -> nn.Linear layout."""
    x, ls, lb, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    return x, ls, lb, w1.T.contiguous(), b1, w2.T.contiguous(), b2


@pytest.mark.parametrize("rows,c", [(200, 32), (64, 64), (40, 1280)])
def test_ff_twin_matches_reference_and_pallas(rows, c):
    """C <= 640 reaches the JAX package's resident kernel, C = 1280 its
    streamed kernel (weights in inner blocks, an f32 accumulator)."""
    args = _ff_args(rows, c)
    got = tff.geglu_ff_reference(*_torch_ff_args(args)).numpy()
    ref = jff.geglu_ff_reference(*(jnp.asarray(a) for a in args))
    # the same float32 exact-erf composition: tight
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    pallas = jff.fused_geglu_ff(*(jnp.asarray(a) for a in args), blk_m=128, interpret=True)
    # the Pallas kernel gates with tanh gelu (|gelu err| <= ~3e-3): the
    # tolerance of tests/test_fused_ff.py
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=5e-3, atol=4e-3)


def test_geglu_ff_on_cpu_uses_the_twin():
    args = _torch_ff_args(_ff_args(16, 32, seed=9))
    before = tff.fused_geglu_ff.launches
    torch.testing.assert_close(tff.geglu_ff(*args), tff.geglu_ff_reference(*args),
                               rtol=0, atol=0)
    assert tff.fused_geglu_ff.launches == before
