"""Parity of the port's kernel-free ops (insv2v_torch.ops) with the JAX
package's: the same numpy inputs through both, float32 on the CPU.

Tolerance 1e-5 absolute unless stated: both sides compute the same
float32 formula and differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from insv2v_tpu.ops import embeddings as jemb
from insv2v_tpu.ops import norms as jnorms
from insv2v_tpu.ops.resize import nearest_upsample_2x as j_up
from insv2v_torch.ops import embeddings as temb
from insv2v_torch.ops import fused_norm as tfn
from insv2v_torch.ops import norms as tnorms
from insv2v_torch.ops.resize import nearest_upsample_2x as t_up


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("regime", ["across_frames", "per_frame"])
def test_fused_group_norm_twin_matches_group_norm_and_jax(regime, silu):
    """Kernel E's plain twin on the (N, M, C) rows each regime views the
    video as (across frames: N = B, M = F*H*W; per frame: N = B*F,
    M = H*W) against today's ATen path (+ F.silu) and the JAX package's
    GroupNorm (+ jax.nn.silu)."""
    b, f, h, w, c, groups = 2, 3, 4, 5, 16, 4
    x = (RS.randn(b, f, h, w, c) * 2 + 0.5).astype(np.float32)
    s, bb = _affine(c)
    axes = None if regime == "across_frames" else (2, 3)
    n = b if regime == "across_frames" else b * f
    (got,) = tfn.fused_group_norm_reference((torch.from_numpy(x).reshape(n, -1, c),),
                                            torch.from_numpy(s), torch.from_numpy(bb), groups,
                                            1e-6, silu)
    aten = tnorms.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(bb),
                             groups, 1e-6, reduce_axes=axes)
    want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb), groups, 1e-6,
                             reduce_axes=axes)
    if silu:
        aten, want = F.silu(aten), jax.nn.silu(want)
    np.testing.assert_allclose(got.reshape(x.shape).numpy(), aten.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.reshape(x.shape).numpy(), np.asarray(want), atol=1e-5)


def test_fused_group_norm_twin_of_a_split_pair_with_a_straddling_group():
    """Two parts of 16 + 8 channels in 3 groups of 8 (the middle one
    straddles the parts): each part equals its slice of the GroupNorm of
    the real concat, and ``group_norm_split_pair`` on the ATen path."""
    x = torch.from_numpy((RS.randn(2, 3, 4, 4, 16) * 2 + 1).astype(np.float32))
    skip = torch.from_numpy((RS.randn(2, 3, 4, 4, 8) * 0.5 - 1).astype(np.float32))
    s, bb = (torch.from_numpy(a) for a in _affine(24))
    xn, sn = tfn.fused_group_norm_reference((x.reshape(2, -1, 16), skip.reshape(2, -1, 8)),
                                            s, bb, 3, 1e-6, True)
    whole = F.silu(tnorms.group_norm(torch.cat([x, skip], -1), s, bb, 3, 1e-6))
    np.testing.assert_allclose(xn.reshape(x.shape).numpy(), whole[..., :16].numpy(), atol=1e-5)
    np.testing.assert_allclose(sn.reshape(skip.shape).numpy(), whole[..., 16:].numpy(), atol=1e-5)
    px, ps = tnorms.group_norm_split_pair(x, skip, s, bb, 3, 1e-6, silu=True)
    np.testing.assert_allclose(px.numpy(), whole[..., :16].numpy(), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), whole[..., 16:].numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["across_frames", "frames_inner", "per_frame", "split_pair",
                                  "gapped_axes", "grad", "float32"])
def test_group_norm_routes_to_kernel_e_only_where_it_can(case, monkeypatch):
    """The routing of ``ops.norms`` with every tensor taken for a CUDA one
    (a spy runs the kernel's twin): bf16 calls that record no
    gradient go to kernel E as (N, M, C) rows, one launch a split pair,
    also where the frames lie innermost (a motion module's output, whose
    layout the output keeps); a gapped axis run, float32 and a call that
    records a gradient keep the ATen path, whose output has a ``grad_fn``
    and whose gradients equal those of the same call with the routing off."""
    calls = []

    def spy(parts, *a, **k):
        calls.append([tuple(p.shape) for p in parts])
        return tfn.fused_group_norm_reference(parts, *a, **k)

    monkeypatch.setattr(tnorms, "fused_group_norm", spy)
    x = torch.from_numpy((RS.randn(2, 3, 4, 4, 16) * 2 + 0.5).astype(np.float32)).bfloat16()
    s, bb = (torch.from_numpy(a).bfloat16() for a in _affine(16))
    want_calls = []
    if case == "grad":
        xg, sg = x.float().requires_grad_(), s.float().requires_grad_()
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        y = tnorms.group_norm(xg.bfloat16(), sg, bb.float(), 4, silu=True)
        assert y.grad_fn is not None
        g_on = torch.autograd.grad(y.float().square().sum(), (xg, sg))
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: False))
        y_off = tnorms.group_norm(xg.bfloat16(), sg, bb.float(), 4, silu=True)
        g_off = torch.autograd.grad(y_off.float().square().sum(), (xg, sg))
        for a, b in zip(g_on, g_off):
            assert torch.equal(a, b)
    else:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        if case == "split_pair":
            skip = x[..., :8].contiguous()
            s2, b2 = (torch.cat([t, t[:8]]) for t in (s, bb))
            got = torch.cat(tnorms.group_norm_split_pair(x, skip, s2, b2, 4, silu=True), -1)
            want = F.silu(tnorms._group_norm_aten(torch.cat([x, skip], -1), s2, b2, 4, 1e-6,
                                                  (1, 2, 3), None))
            want_calls = [[(2, 48, 16), (2, 48, 8)]]
        else:
            xin = x.float() if case == "float32" else x
            if case == "frames_inner":
                xin = x.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
            axes = {"per_frame": (2, 3), "gapped_axes": (1, 3)}.get(case)
            got = tnorms.group_norm(xin, s, bb, 4, reduce_axes=axes, silu=True)
            want = F.silu(tnorms._group_norm_aten(xin, s, bb, 4, 1e-6, axes or (1, 2, 3), None))
            if case == "frames_inner":
                assert got.stride() == xin.stride()
            want_calls = {"across_frames": [[(2, 48, 16)]], "frames_inner": [[(2, 48, 16)]],
                          "per_frame": [[(6, 16, 16)]]}.get(case, [])
        # the twin rounds once, the ATen path after the affine and after the
        # SiLU: up to two bf16 roundings apart (2^-8 relative each)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    assert calls == want_calls


@pytest.mark.parametrize("n,m,c", [(3, 24576, 320), (48, 96, 1280), (3, 147456, 320),
                                   (3, 1536, 1920), (2, 7, 8), (5, 33, 4096), (48, 1536, 320)])
def test_group_norm_plan_covers_every_row(n, m, c):
    """Kernel E's blocks: 32 to 512 threads of 8 channels, whole row lanes,
    a sample's chunks cover its M rows exactly once, and the blocks fill
    at most as many waves of 528 slots as 64 rows a thread need."""
    rpar, rows, chunks = tfn.group_norm_plan(n, m, c, 528)
    assert 32 <= c // 8 * rpar <= 512 and rows % rpar == 0 and rows >= 8 * rpar
    assert (chunks - 1) * rows < m <= chunks * rows
    waves = -(-n * m // (rpar * 528 * 64))
    assert n * chunks <= 528 * waves or rows == 8 * rpar


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
