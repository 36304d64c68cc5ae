"""Kernels A' and D of the port (their plain twins against the JAX
package's Pallas kernels in interpret mode) and the gradient rule of every
kernel wrapper (``ops.recompute.KernelGrad``: the backward recomputes the
plain twin) against ``jax.vjp`` of the JAX package's references, on the
CPU in float32. The CUDA kernels and their backward are held against the
twins on the card by tests/test_torch_gpu_kernels.py.

Inputs are made with numpy from a seed and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.ops import attention as jattn
from insv2v_tpu.ops import fused_ff as jff
from insv2v_tpu.ops import norms as jnorms
from insv2v_tpu.ops.fused_norm import fused_layer_norm as j_fused_layer_norm
from insv2v_torch.ops import attention as tattn
from insv2v_torch.ops import fused_ff as tff
from insv2v_torch.ops import fused_norm as tln
from insv2v_torch.ops import norms as tnorms
from insv2v_torch.ops.recompute import KernelGrad


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


# --- kernel A': flash attention, all heads of a query block ------------------

def test_headfold_twin_matches_pallas_headfold_kernel():
    """Ragged lengths (150, 170 against 128 blocks), three heads; as
    tests/test_ops.py runs the headfold kernel. Tolerance 2e-5: float32
    online softmax vs one-shot softmax."""
    q, k, v = rnd(2, 3, 150, 40, seed=5), rnd(2, 3, 170, 40, seed=6), rnd(2, 3, 170, 40, seed=7)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk_q=128,
                                 blk_k=128, interpret=True, headfold=True)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for got in (tattn.flash_attention_headfold(tq, tk, tv),
                tattn.flash_attention(tq, tk, tv, headfold=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_headfold_wrapper_takes_the_twin_on_cpu_and_counts_no_launch():
    q = torch.from_numpy(rnd(1, 2, 300, 40))
    before = tattn.flash_attention_headfold.launches, tattn.flash_attention.launches
    out = tattn.flash_attention(q, q, q, headfold=True)
    assert (tattn.flash_attention_headfold.launches, tattn.flash_attention.launches) == before
    torch.testing.assert_close(out, tattn.attention(q, q, q), rtol=0, atol=0)


# --- kernel D: row-wise LayerNorm ---------------------------------------------

@pytest.mark.parametrize("shape", [(3, 50, 64), (70, 320)])
def test_layer_norm_twin_matches_pallas_ln_kernel(shape):
    """Off-centre inputs (mean 1, scale 3) so the centred variance matters.
    Tolerance 2e-5 (tests/test_ops.py's for the Pallas kernel)."""
    c = shape[-1]
    x = rnd(*shape, seed=20) * 3 + 1
    scale, bias = rnd(c, seed=21) * 0.1 + 1.0, rnd(c, seed=22) * 0.1
    want = j_fused_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              block_rows=64, interpret=True)
    plain = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tln.fused_layer_norm(*(torch.from_numpy(t) for t in (x, scale, bias))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-5)


def test_layer_norm_switch_dispatches_to_the_kernel_wrapper(monkeypatch):
    """``fused=True`` (or the module default) goes through fused_layer_norm,
    whose CPU path is the twin; the FF twin's LayerNorm never does."""
    x, s, b = (torch.from_numpy(rnd(*sh, seed=i)) for i, sh in enumerate([(9, 32), (32,), (32,)]))
    calls = []
    monkeypatch.setattr(tnorms, "fused_layer_norm",
                        lambda *a, **k: calls.append(1) or tln.fused_layer_norm(*a, **k))
    torch.testing.assert_close(tnorms.layer_norm(x, s, b, fused=True),
                               tln.fused_layer_norm_reference(x, s, b), rtol=0, atol=0)
    assert calls == [1]
    tnorms.layer_norm(x, s, b, fused=False)
    monkeypatch.setattr(tnorms, "FUSED_LAYER_NORM", True)
    tnorms.layer_norm(x, s, b)
    assert calls == [1, 1]
    c = 32
    ff = (torch.from_numpy(rnd(5, c)), s, b, torch.from_numpy(rnd(8 * c, c, scale=0.1)),
          torch.zeros(8 * c), torch.from_numpy(rnd(c, 4 * c, scale=0.1)), torch.zeros(c))
    tff.geglu_ff_reference(*ff)
    assert calls == [1, 1]


def test_layer_norm_wrapper_on_cpu_counts_no_launch():
    x = torch.from_numpy(rnd(4, 64))
    before = tln.fused_layer_norm.launches
    tln.fused_layer_norm(x, torch.ones(64), torch.zeros(64))
    assert tln.fused_layer_norm.launches == before


# --- the gradient rule of every kernel wrapper --------------------------------

def _pack(t):
    """(B, P, F, heads, e) -> the JAX packed layout (B, P, F*heads, e)."""
    b, p, f, h, e = t.shape
    return t.reshape(b, p, f * h, e)


def _case(name):
    """(torch twin, JAX reference, numpy inputs, JAX inputs from numpy,
    JAX grads back to the torch layout)."""
    ident = lambda *a: a
    if name == "flash":
        ins = [rnd(2, 2, 60, 40, seed=s) for s in (1, 2, 3)]
        return (tattn.flash_attention_reference, jattn.attention, ins, ident,
                lambda g: [np.asarray(t) for t in g])
    if name == "temporal":
        ins = [rnd(2, 6, 5, 2, 8, seed=s) for s in (4, 5, 6)]
        return (tattn.temporal_attention_reference,
                lambda q, k, v: jattn.packed_temporal_attention_xla(q, k, v, heads=2), ins,
                lambda *a: [_pack(t) for t in a],
                lambda g: [np.asarray(t).reshape(2, 6, 5, 2, 8) for t in g])
    if name == "ff":
        c, inner = 16, 64
        ins = [rnd(20, c, seed=7), 1.0 + rnd(c, seed=8, scale=0.1), rnd(c, seed=9, scale=0.1),
               rnd(2 * inner, c, seed=10, scale=0.2), rnd(2 * inner, seed=11, scale=0.1),
               rnd(c, inner, seed=12, scale=0.2), rnd(c, seed=13, scale=0.1)]
        # nn.Linear layout (w1 (2*inner, C), w2 (C, inner)) <-> the JAX (in, out)
        to_jax = lambda x, s, b, w1, b1, w2, b2: (x, s, b, w1.T, b1, w2.T, b2)
        back = lambda g: [np.asarray(t).T if i in (3, 5) else np.asarray(t)
                          for i, t in enumerate(g)]
        return tff.geglu_ff_reference, jff.geglu_ff_reference, ins, to_jax, back
    ins = [rnd(12, 24, seed=14) * 2 + 1, 1.0 + rnd(24, seed=15, scale=0.1),
           rnd(24, seed=16, scale=0.1)]
    return (tln.fused_layer_norm_reference, jnorms.layer_norm, ins, ident,
            lambda g: [np.asarray(t) for t in g])


@pytest.mark.parametrize("name", ["flash", "temporal", "ff", "layer_norm"])
def test_kernel_grad_rule_matches_jax_vjp(name):
    """KernelGrad with the twin in the kernel's place (the CPU stand-in for
    the launch) against jax.vjp of the reference the JAX custom_vjp
    recomputes: every input's gradient, float32, tolerance 2e-5 relative to
    the gradient's largest entry."""
    twin, jref, ins, to_jax, back = _case(name)
    out_shape = twin(*(torch.from_numpy(t) for t in ins)).shape
    cot = rnd(*out_shape, seed=99)
    xs = [torch.from_numpy(t).requires_grad_() for t in ins]
    out = KernelGrad.apply(twin, twin, *xs)
    out.backward(torch.from_numpy(cot))
    jout, vjp = jax.vjp(jref, *to_jax(*(jnp.asarray(t) for t in ins)))
    want = back(vjp(jnp.asarray(cot).reshape(jout.shape)))
    np.testing.assert_allclose(out.detach().numpy().reshape(-1),
                               np.asarray(jout).reshape(-1), atol=2e-5)
    for i, (x, w) in enumerate(zip(xs, want)):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"{name} input {i}")


def test_kernel_grad_skips_inputs_that_need_no_gradient():
    """Frozen weights (requires_grad False) get no gradient and cost no
    backward work; the inputs that need one get the twin's."""
    twin = tff.geglu_ff_reference
    ins = [torch.from_numpy(t) for t in _case("ff")[2]]
    x = ins[0].clone().requires_grad_()
    KernelGrad.apply(twin, twin, x, *ins[1:]).sum().backward()
    xr = ins[0].clone().requires_grad_()
    twin(xr, *ins[1:]).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=0)
    assert all(t.grad is None for t in ins[1:])
