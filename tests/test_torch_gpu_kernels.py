"""The port's CUDA kernels A, A', B, C and D against their plain PyTorch twins on
the card (marker ``gpu``; they skip on a machine without one, where the
kernels cannot build). This file imports torch and the port only, so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu

Inputs are bf16; the twin runs in float32 on the same values. The
tolerances are bf16-level (8 mantissa bits) on O(1) outputs."""

import pytest
import torch

from insv2v_torch.ops import attention as tattn
from insv2v_torch.ops import fused_ff as tff
from insv2v_torch.ops import fused_norm as tln

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=gen.device) * scale).bfloat16()


@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 8, 300, 300, 40), (2, 8, 384, 260, 80),
                                         (1, 2, 100, 700, 80), (1, 1, 260, 300, 512)])
def test_flash_kernel_matches_twin(cuda, b, h, sq, sk, d):
    """Ragged lengths (not multiples of the 64 or 32 key tiles), sq != sk."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _randn(g, b, h, sq, d), _randn(g, b, h, sk, d), _randn(g, b, h, sk, d)
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    ref = tattn.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 8, 300, 300, 40), (2, 8, 384, 260, 80),
                                         (1, 3, 100, 700, 80)])
def test_flash_headfold_kernel_matches_twin(cuda, b, h, sq, sk, d):
    """Kernel A': ragged lengths, sq != sk, an odd head count."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = _randn(g, b, h, sq, d), _randn(g, b, h, sk, d), _randn(g, b, h, sk, d)
    before = tattn.flash_attention_headfold.launches, tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v, headfold=True)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_headfold.launches, tattn.flash_attention.launches) == \
        (before[0] + 1, before[1])
    ref = tattn.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2
    # the same block body as kernel A: the same numbers
    torch.testing.assert_close(out, tattn.flash_attention(q, k, v, headfold=False),
                               rtol=0, atol=0)


@pytest.mark.parametrize("rows,c", [(1000, 320), (77, 768), (40, 1280), (7, 640), (9, 72)])
def test_layer_norm_kernel_matches_twin(cuda, rows, c):
    """Kernel D at the UNet and CLIP widths, ragged row counts and a width
    that leaves most lanes idle. Tolerance: one bf16 rounding of O(1)
    outputs (2^-8 relative)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = (_randn(g, rows, c).float() * 3 + 1).bfloat16()
    scale, bias = 1.0 + 0.1 * _randn(g, c).float(), 0.1 * _randn(g, c).float()
    before = tln.fused_layer_norm.launches
    out = tln.fused_layer_norm(x, scale, bias)
    torch.cuda.synchronize()
    assert tln.fused_layer_norm.launches == before + 1
    ref = tln.fused_layer_norm_reference(x, scale, bias).float()
    assert (out.float() - ref).abs().max().item() <= 2e-2


def _grad_case(name, g):
    """(wrapper, twin, inputs) of one kernel at a small shape."""
    if name in ("flash", "flash_headfold"):
        ts = [_randn(g, 2, 4, 300, 40) for _ in range(3)]
        hf = name == "flash_headfold"
        return (lambda *a: tattn.flash_attention(*a, headfold=hf),
                tattn.flash_attention_reference, ts)
    if name == "temporal":
        return tattn.temporal_attention, tattn.temporal_attention_reference, \
            [_randn(g, 2, 30, 16, 8, 40) for _ in range(3)]
    if name == "ff":
        c, inner = 320, 1280
        ts = [_randn(g, 100, c), (1.0 + 0.1 * _randn(g, c).float()).bfloat16(),
              _randn(g, c, scale=0.1), _randn(g, 2 * inner, c, scale=c ** -0.5),
              _randn(g, 2 * inner, scale=0.1), _randn(g, c, inner, scale=inner ** -0.5),
              _randn(g, c, scale=0.1)]
        return tff.fused_geglu_ff, tff.geglu_ff_reference, ts
    c = 640
    return tln.fused_layer_norm, tln.fused_layer_norm_reference, \
        [_randn(g, 100, c), (1.0 + 0.1 * _randn(g, c).float()).bfloat16(),
         _randn(g, c, scale=0.1)]


@pytest.mark.parametrize("name", ["flash", "flash_headfold", "temporal", "ff", "layer_norm"])
def test_kernel_backward_matches_twin_autograd(cuda, name):
    """The wrappers' outputs carry gradients to every input: the kernel's
    backward (the twin recomputed) against autograd through the twin on
    the same bf16 inputs. Both run the same bf16 ops, so they agree to
    1e-3 relative L2 (summation order inside the library kernels)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    fn, twin, ts = _grad_case(name, g)
    cot = _randn(g, *twin(*ts).shape)
    grads = {}
    for which, f in (("kernel", fn), ("twin", twin)):
        xs = [t.clone().requires_grad_() for t in ts]
        (f(*xs).float() * cot.float()).sum().backward()
        grads[which] = [x.grad for x in xs]
    for i, (a, b) in enumerate(zip(grads["kernel"], grads["twin"])):
        assert a is not None and torch.isfinite(a).all(), (name, i)
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-3, (name, i, rel)


@pytest.mark.parametrize("rows,c", [(1000, 320), (96, 640), (40, 1280), (7, 320)])
def test_ff_kernel_matches_twin(cuda, rows, c):
    """Row counts that leave a ragged last row tile."""
    g = torch.Generator(device=cuda).manual_seed(3)
    inner = 4 * c
    args = (_randn(g, rows, c), (1.0 + 0.1 * _randn(g, c).float()).bfloat16(),
            _randn(g, c, scale=0.1), _randn(g, 2 * inner, c, scale=c ** -0.5),
            _randn(g, 2 * inner, scale=0.1), _randn(g, c, inner, scale=inner ** -0.5),
            _randn(g, c, scale=0.1))
    before = tff.fused_geglu_ff.launches
    out = tff.fused_geglu_ff(*args)
    torch.cuda.synchronize()
    assert tff.fused_geglu_ff.launches == before + 1
    ref = tff.geglu_ff_reference(*(a.float() for a in args))
    assert (out.float() - ref).abs().max().item() <= 6e-2


@pytest.mark.parametrize("f,e", [(16, 40), (16, 160), (32, 160), (5, 8)])
def test_temporal_kernel_matches_twin(cuda, f, e):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(g, 2, 50, f, 8, e) for _ in range(3))
    before = tattn.temporal_attention.launches
    out = tattn.temporal_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.temporal_attention.launches == before + 1
    ref = tattn.temporal_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 1, 300, 40, device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        tattn.flash_attention(q, q, q)
    qb = torch.zeros(1, 1, 300, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.flash_attention(qb, qb, qb)
    t = torch.zeros(1, 2, 33, 2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.temporal_attention(t, t, t)
    c, inner = 64, 256
    z = lambda *s: torch.zeros(*s, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tff.fused_geglu_ff(z(8, c), z(c), z(c), z(2 * inner, c), z(2 * inner), z(c, inner), z(c))
    with pytest.raises(ValueError):
        tln.fused_layer_norm(z(4, 1288), z(1288), z(1288))
    with pytest.raises(TypeError):
        tln.fused_layer_norm(z(4, 320).float(), z(320), z(320))
