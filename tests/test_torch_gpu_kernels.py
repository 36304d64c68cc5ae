"""The port's CUDA kernels A, A', B, C, D and E against their plain PyTorch twins on
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
                                         (1, 2, 100, 700, 80), (1, 1, 260, 300, 512),
                                         (2, 1, 1024, 1000, 512), (1, 1, 40, 300, 512),
                                         (2, 5, 1000, 1000, 64), (4, 10, 256, 256, 64),
                                         (1, 3, 300, 1024, 64), (2, 5, 1024, 1024, 64)])
def test_flash_kernel_matches_twin(cuda, b, h, sq, sk, d):
    """Ragged lengths (not multiples of the 64-key tiles at d = 40/80, the
    128-key tiles at d = 64 or the 32-key tiles at d = 512, nor of the 64,
    128 or 192 query rows of a work item), sq != sk; at d = 512 the
    training depth and fewer queries than one query block; at d = 64
    (ModelScope) its two self-attention lengths exactly, and ragged."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _randn(g, b, h, sq, d), _randn(g, b, h, sk, d), _randn(g, b, h, sk, d)
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    ref = tattn.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 8, 300, 300, 40), (2, 8, 384, 260, 80),
                                         (1, 3, 100, 700, 80), (3, 8, 256, 256, 80),
                                         (2, 8, 1024, 1024, 40), (34, 2, 384, 300, 40),
                                         (2, 10, 256, 256, 64), (40, 5, 1000, 1000, 64),
                                         (2, 5, 1024, 1024, 64), (1, 3, 300, 1024, 64)])
def test_flash_headfold_kernel_matches_twin(cuda, b, h, sq, sk, d):
    """Kernel A': ragged lengths, sq != sk, an odd head count, and training's
    shapes at a small batch: fewer blocks than SMs, several heads per
    consumer warpgroup. (34, 2, 384, 300, 40) has enough (batch, query
    block) blocks for the form whose warpgroups share one K/V ring. At
    d = 64 ModelScope's lengths exactly and ragged, with a batch's heads
    split over blocks (few blocks) and not (many)."""
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


def test_flash_headfold_cases_cover_both_forms(cuda):
    """The cases above reach both forms of kernel A' at d = 40/80 as its
    launcher chooses them: two warpgroups with a ring each over 64-query
    blocks where blocks are few, three on a shared ring otherwise. At
    d = 64 A' has one body, two warpgroups on 128-row items, whose heads
    are split over blocks where (batch, query block) pairs are few."""
    assert tattn.flash_grid(3, 8, 256, 80, headfold=True)["warpgroups"] == 2
    assert tattn.flash_grid(34, 2, 384, 40, headfold=True)["warpgroups"] == 3
    few, many = (tattn.flash_grid(2, 10, 256, 64, headfold=True),
                 tattn.flash_grid(40, 5, 1000, 64, headfold=True))
    assert few["warpgroups"] == many["warpgroups"] == 2
    assert few["blocks"] > 2 * 2 and many["blocks"] == 40 * 8


@pytest.mark.parametrize("b,h,s", [(64, 5, 1024), (64, 10, 256), (32, 5, 1024), (32, 10, 256)])
def test_flash_d64_grid_takes_128_row_items(cuda, b, h, s):
    """At d = 64 (the data-generation shapes) A and A' take 128-row work
    items of two warpgroups, which divide S = 1024 and 256, and 128-key
    tiles; A is persistent, A' covers every (batch, query block) pair.
    d = 40 and 80 keep their own grids: 192- and 128-row items, 64-key
    tiles."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    a, af = (tattn.flash_grid(b, h, s, 64, headfold=hf) for hf in (False, True))
    for g in (a, af):
        assert (g["warpgroups"], g["rows"], g["key_tile"]) == (2, 128, 128)
        assert g["items"] == b * h * (s // 128)
    assert a["blocks"] == min(a["items"], sms)
    assert af["blocks"] % (b * (s // 128)) == 0 and af["blocks"] <= max(sms, b * (s // 128))
    for d, rows in ((40, 192), (80, 128)):
        g = tattn.flash_grid(48, 8, 1536, d, headfold=False)
        assert (g["rows"], g["key_tile"]) == (rows, 64)


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


# kernel E: (N, M, channels of each part, groups, silu): the edit's
# ResnetBlock3D norms at levels 0-3 (across frames, N = 3, M = 16 * H * W)
# and its transformer / motion norms (per frame, N = 48), the edit's split
# pairs (640 + 320, 320 + 320, 1280 + 640, 1280 + 1280), SDXL's level 0
# (442 368 rows of 320) and its 1 920-channel pair, UNetSD's per-frame
# (64 = 4 * 16 frames of 32 x 32) and across-frames (TemporalConvBlock)
# norms, the VAE's 128-, 256- and 512-channel levels (16, 8 or 4 rows a
# block at once), and ragged tiny ones
GN_CASES = [(3, 24576, (320,), 32, True), (3, 6144, (640,), 32, True),
            (3, 1536, (1280,), 32, True), (3, 384, (1280,), 32, True),
            (48, 1536, (320,), 32, False), (48, 96, (1280,), 32, False),
            (3, 24576, (640, 320), 32, True), (3, 24576, (320, 320), 32, True),
            (3, 1536, (1280, 640), 32, True), (3, 384, (1280, 1280), 32, True),
            (3, 147456, (320,), 32, True), (3, 36864, (1280, 640), 32, True),
            (64, 1024, (320,), 32, True), (4, 16384, (320,), 32, True),
            (4, 98304, (128,), 32, True), (16, 24576, (256,), 32, True),
            (16, 1536, (512,), 32, False), (2, 7, (8,), 4, True), (1, 1, (16, 8), 3, False),
            (5, 33, (2560, 1536), 32, False)]


def _gn_inputs(g, n, m, widths, mean=0.5, spread=2.0):
    c = sum(widths)
    parts = tuple((_randn(g, n, m, w).float() * spread + mean).bfloat16() for w in widths)
    scale, bias = 1.0 + 0.1 * _randn(g, c).float(), 0.1 * _randn(g, c).float()
    return parts, scale, bias


@pytest.mark.parametrize("n,m,widths,groups,silu", GN_CASES)
def test_group_norm_kernel_matches_twin(cuda, n, m, widths, groups, silu):
    """Kernel E against its float32 twin on the same bf16 values, one launch
    a call; with bf16 scale and bias too (the models' own dtype).
    Tolerance: one bf16 rounding of O(1) outputs (2^-8 relative)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    parts, scale, bias = _gn_inputs(g, n, m, widths)
    for sc, bi in ((scale, bias), (scale.bfloat16(), bias.bfloat16())):
        before = tln.fused_group_norm.launches
        out = tln.fused_group_norm(parts, sc, bi, groups, 1e-5, silu)
        torch.cuda.synchronize()
        assert tln.fused_group_norm.launches == before + 1
        ref = tln.fused_group_norm_reference(tuple(p.float() for p in parts), sc, bi, groups,
                                             1e-5, silu)
        for o, r, p in zip(out, ref, parts):
            assert o.shape == p.shape and o.dtype == torch.bfloat16
            assert (o.float() - r).abs().max().item() <= 2e-2


def test_group_norm_kernel_holds_the_variance_of_a_far_mean(cuda):
    """Values 100 times their spread, 1.47 M a group (SDXL's level 0): the
    shifted sums keep the variance, so the output is the twin's."""
    g = torch.Generator(device=cuda).manual_seed(12)
    parts, scale, bias = _gn_inputs(g, 3, 147456, (320,), mean=100.0, spread=1.0)
    (out,) = tln.fused_group_norm(parts, scale, bias, 32, 1e-6, False)
    (ref,) = tln.fused_group_norm_reference((parts[0].float(),), scale, bias, 32, 1e-6, False)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert abs(ref.std().item() - out.float().std().item()) <= 1e-3


def test_group_norm_kernel_replays_from_a_cuda_graph_bit_for_bit(cuda):
    """One capture of kernel E (a split pair with its SiLU), replayed twice:
    each replay equals the eager call bit for bit (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    parts, scale, bias = _gn_inputs(g, 3, 24576, (640, 320))
    eager = tln.fused_group_norm(parts, scale, bias, 32, 1e-5, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tln.fused_group_norm(parts, scale, bias, 32, 1e-5, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = tln.fused_group_norm(parts, scale, bias, 32, 1e-5, True)
    for _ in range(2):
        for o in static:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))


@pytest.mark.parametrize("case", ["across_frames", "frames_inner", "per_frame", "split_pair"])
def test_group_norms_of_the_models_take_kernel_e(cuda, case):
    """``ops.norms`` on the card: the UNet's across-frames norm (also on a
    motion module's output, frames innermost), a per-frame norm and a
    split pair each launch kernel E once, keep the input's layout, and
    agree with the ATen path (one bf16 rounding and the SiLU's apart)."""
    from insv2v_torch.ops import norms

    g = torch.Generator(device=cuda).manual_seed(14)
    x = (_randn(g, 3, 16, 8, 12, 320).float() * 2 + 0.5).bfloat16()
    if case == "frames_inner":
        x = x.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
    scale, bias = (1.0 + 0.1 * _randn(g, 320)), 0.1 * _randn(g, 320)
    before = tln.fused_group_norm.launches
    with torch.no_grad():
        if case == "split_pair":
            skip = (_randn(g, 3, 16, 8, 12, 640).float() - 1).bfloat16()
            s2, b2 = (1.0 + 0.1 * _randn(g, 960)), 0.1 * _randn(g, 960)
            got = torch.cat(norms.group_norm_split_pair(x, skip, s2, b2, 32, silu=True), -1)
            want = torch.nn.functional.silu(
                norms._group_norm_aten(torch.cat([x, skip], -1), s2, b2, 32, 1e-6, (1, 2, 3), None))
        else:
            axes = (2, 3) if case == "per_frame" else None
            got = norms.group_norm(x, scale, bias, 32, reduce_axes=axes, silu=True)
            want = torch.nn.functional.silu(
                norms._group_norm_aten(x, scale, bias, 32, 1e-6, axes or (1, 2, 3), None))
            assert got.stride() == x.stride()
    torch.cuda.synchronize()
    assert tln.fused_group_norm.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_group_norm_kernel_refuses_what_it_does_not_take(cuda):
    """float32, a non-contiguous part, a group count that does not divide
    the channels, a part of 12 channels, a recorded gradient: each raises,
    and nothing falls back to the twin."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, device=cuda, dtype=dt)
    one, nil = torch.ones(320, device=cuda), torch.zeros(320, device=cuda)
    before = tln.fused_group_norm.launches
    with pytest.raises(TypeError):
        tln.fused_group_norm((z(2, 64, 320, dt=torch.float32),), one, nil, 32)
    with pytest.raises(TypeError):
        tln.fused_group_norm((z(2, 320, 64).transpose(1, 2),), one, nil, 32)
    with pytest.raises(ValueError):
        tln.fused_group_norm((z(2, 64, 320),), one, nil, 30)
    with pytest.raises(ValueError):
        tln.fused_group_norm((z(2, 64, 308), z(2, 64, 12)), one, nil, 32)
    with pytest.raises(ValueError):
        tln.fused_group_norm((z(2, 64, 320).requires_grad_(),), one, nil, 32)
    assert tln.fused_group_norm.launches == before


def _grad_case(name, g):
    """(wrapper, twin, inputs) of one kernel at a small shape."""
    if name == "flash_wide":
        return tattn.flash_attention, tattn.flash_attention_reference, \
            [_randn(g, 1, 1, 300, 512) for _ in range(3)]
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


@pytest.mark.parametrize("name", ["flash", "flash_headfold", "flash_wide", "temporal", "ff",
                                  "layer_norm"])
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


@pytest.mark.parametrize("rows,c", [(1000, 320), (96, 640), (40, 1280), (7, 320), (200, 1280),
                                    (64 + 5, 640), (256, 1280), (1, 320), (9000, 320)])
def test_ff_kernel_matches_twin(cuda, rows, c):
    """Row counts that leave the last 128-row tile ragged, or its second
    half of 64 rows partly or wholly empty ((200, 1280), (69, 640),
    (40, 1280), (1, 320)); training's deepest shape (256, 1280), with fewer
    blocks than SMs; (9000, 320), whose B-i blocks take several column
    tiles, the two warpgroups taking turns."""
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


def test_ff_cases_cover_both_gate_kernels(cuda):
    """The cases above reach both B-i kernels (LN(x) resident at C <= 640,
    x streamed at C = 1280) with one and with several column tiles a
    block, as the launcher chooses them."""
    big, wide = tff.ff_grid(9000, 320, 1280), tff.ff_grid(200, 1280, 5120)
    assert (big["gate_cols"], wide["gate_cols"]) == (64, 128)
    assert big["gate_tiles"] > 1 and wide["gate_tiles"] == 1


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


@pytest.mark.parametrize("p", [7, 301])
@pytest.mark.parametrize("heads", [1, 5, 8])
@pytest.mark.parametrize("e", [8, 40, 80, 160])
@pytest.mark.parametrize("f", [1, 5, 16, 17, 32])
def test_temporal_kernel_shapes_match_twin(cuda, f, e, heads, p):
    """Kernel C at every frame tiling (1, 5 and 16 frames in the 16-frame
    tile, 17 and 32 in the 32-frame one), every compiled head width (8 and
    40 padded in the fragments, 80 and 160 not), one, five and eight heads
    (whole-pixel units and units of fewer heads), at 7 pixels (P * heads
    below the SM count: each unit its own block) and 301 (no multiple of
    the blocks: persistent blocks walk uneven numbers of units)."""
    g = torch.Generator(device=cuda).manual_seed(f * 1000 + e * 10 + heads)
    q, k, v = (_randn(g, 1, p, f, heads, e) for _ in range(3))
    out = tattn.temporal_attention(q, k, v)
    torch.cuda.synchronize()
    ref = tattn.temporal_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2
    grid = tattn.temporal_grid(1, p, f, heads, e)
    assert grid["units"] == p * heads // grid["heads_per_unit"]
    assert grid["blocks"] == grid["units"] if p == 7 else grid["blocks"] <= grid["units"]


def test_temporal_grid_units_follow_the_shapes(cuda):
    """Kernel C's work units: whole pixels (8 heads) at the edit's 40-wide
    level, 4 and 2 heads where a whole pixel's stage would not fit
    (e = 80, 160), one head where the units would be too few for the SMs
    (the 24-pixel level); blocks persistent, never more than the units or
    than the SMs hold."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape, per_unit in (((3, 1536, 16, 8, 40), 8), ((3, 384, 16, 8, 80), 4),
                            ((3, 96, 16, 8, 160), 2), ((3, 24, 16, 8, 160), 1)):
        b, p, f, heads, e = shape
        grid = tattn.temporal_grid(*shape)
        assert grid["heads_per_unit"] == per_unit
        assert grid["units"] == b * p * heads // per_unit
        assert grid["threads"] == 32 * (per_unit + 1)
        assert grid["blocks"] == min(grid["units"], grid["resident"] * sms)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 1, 300, 40, device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        tattn.flash_attention(q, q, q)
    qb = torch.zeros(1, 1, 300, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.flash_attention(qb, qb, qb)
    # d = 64 in float32, d = 64 not contiguous, and d = 96 (not compiled)
    q64 = torch.zeros(1, 2, 300, 64, device=cuda)
    with pytest.raises(TypeError):
        tattn.flash_attention(q64, q64, q64, headfold=True)
    q64 = q64.bfloat16().transpose(1, 2)
    with pytest.raises(ValueError):
        tattn.flash_attention(q64, q64, q64)
    q96 = torch.zeros(1, 2, 300, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.flash_attention(q96, q96, q96)
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


def test_unet_split_skip_path_matches_concat_path_through_the_kernels(cuda, monkeypatch):
    """The up blocks' split-skip path against the concat path on the card:
    the smallest UNet whose widths the kernels take (the full widths, one
    resnet a down block), batch 3 (the edit's CFG batch) of 4 frames of
    32x48 latents, the same weights. In bf16 both calls launch A, B and C
    and differ by bf16 roundings only: 2.5e-2 relative L2, twice one call's
    bf16 error against float32 (chip_smoke.py's SPLIT_TOL). In float32,
    through the kernels' plain twins with TF32 off, they agree to 1e-4."""
    import dataclasses

    from insv2v_torch.models import unet3d
    from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig

    torch.manual_seed(0)
    with torch.device(cuda):
        model = UNet3DConditionModel(UNetConfig(layers_per_block=1)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "temporal_transformer.proj_out" in name:  # zero at init: wake it
                p.normal_(0.0, 0.02)
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(3, 4, 32, 48, 8, generator=g, device=cuda)
    ctx = torch.randn(3, 77, 768, generator=g, device=cuda)
    t = torch.tensor([300, 500, 700], device=cuda)
    kernels = (tattn.flash_attention, tff.fused_geglu_ff, tattn.temporal_attention)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()

    def call(split, dtype):
        model.cfg = dataclasses.replace(model.cfg, split_skip=split)
        with torch.no_grad():
            return model.to(dtype)(x.to(dtype), t, ctx.to(dtype), video_start_index=2)

    outs = {}
    for split in (True, False):
        before = [k.launches for k in kernels]
        outs[split] = call(split, torch.bfloat16)
        torch.cuda.synchronize()
        assert all(k.launches > b for k, b in zip(kernels, before)), split
    assert torch.isfinite(outs[True]).all()
    assert rel(outs[True], outs[False]) <= 2.5e-2, rel(outs[True], outs[False])

    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v, scale=None, headfold=None:
                        tattn.flash_attention_reference(q, k, v, scale))
    monkeypatch.setattr(unet3d, "temporal_attention", tattn.temporal_attention_reference)
    monkeypatch.setattr(unet3d, "geglu_ff", tff.geglu_ff_reference)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    f32 = {split: call(split, torch.float32) for split in (True, False)}
    assert rel(f32[True], f32[False]) <= 1e-4, rel(f32[True], f32[False])
