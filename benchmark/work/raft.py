"""Operations and bytes of one RAFT pair (``reference/raft.py``), reckoned
from the configuration and the image size: what the algorithm needs,
whatever implements it.

Operations: the products' multiply-adds as 2 each (every convolution of
the two encoders, the correlation volume's matrix product, the update's
convolutions each iteration, the mask head and the convex upsampling's
combination), as ``FlopCounterMode`` counts the reference. Left out: the
norms, activations, GRU gates, pooling and the bilinear taps of the
lookup (under 1 % of the products at the published widths).

Bytes, float32 (4 a number): every convolution's input, weights and output
once; the volume written once and each pooled level written once and read
once; each iteration's lookup reading the 4 corners of every sample and
writing its features; the upsampling reading the mask and the flow and
writing the flow at full resolution.
"""

from __future__ import annotations

from typing import List, Tuple

F32 = 4
PEAK_TF32_FLOPS = 494.7e12  # NVIDIA H100 SXM, dense TF32 (data sheet)
Work = Tuple[float, float]  # (operations, bytes)


def _conv(cin: int, cout: int, kh: int, kw: int, h: int, w: int, images: int = 1,
          stride: int = 1) -> Work:
    """A convolution with its output at (h, w)."""
    flops = 2.0 * images * cout * cin * kh * kw * h * w
    act = images * (cin * stride * stride + cout) * h * w
    return flops, F32 * (act + cout * cin * kh * kw + cout)


def _encoder(height: int, width: int, out: int, base: int, images: int) -> List[Work]:
    """conv 7x7/2, stages (base, 1.5 base, 2 base) at strides (1, 2, 2) of
    two residual blocks, the 1x1 head."""
    h, w = height // 2, width // 2
    items = [_conv(3, base, 7, 7, h, w, images, 2)]
    cin = base
    for planes, stride in ((base, 1), (base * 3 // 2, 2), (base * 2, 2)):
        h, w = h // stride, w // stride
        items.append(_conv(cin, planes, 3, 3, h, w, images, stride))
        items.append(_conv(planes, planes, 3, 3, h, w, images))
        if stride != 1 or cin != planes:
            items.append(_conv(cin, planes, 1, 1, h, w, images, stride))
        items += [_conv(planes, planes, 3, 3, h, w, images)] * 2
        cin = planes
    items.append(_conv(cin, out, 1, 1, h, w, images))
    return items


def raft_pair(height: int, width: int, feature_dim: int = 256, hidden_dim: int = 128,
              context_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
              iters: int = 12, base_width: int = 64) -> Work:
    """(operations, bytes) of one (image1, image2) pair at (height, width)."""
    h, w = height // 8, width // 8
    n = h * w
    items = _encoder(height, width, feature_dim, base_width, 2)
    items += _encoder(height, width, hidden_dim + context_dim, base_width, 1)
    vol = n * n
    pooled = sum(n * (h >> lvl) * (w >> lvl) for lvl in range(1, corr_levels))
    items.append((2.0 * vol * feature_dim, F32 * (2 * n * feature_dim + vol + 2 * pooled)))
    taps = corr_levels * (2 * corr_radius + 1) ** 2
    inp = context_dim + 128  # the motion features: 126 + the 2 of the flow
    step = [(0.0, F32 * 5 * taps * n),  # the lookup: 4 corners read, the sample written
            _conv(taps, 256, 1, 1, h, w), _conv(256, 192, 3, 3, h, w),
            _conv(2, 128, 7, 7, h, w), _conv(128, 64, 3, 3, h, w),
            _conv(256, 126, 3, 3, h, w)]
    for kh, kw in ((1, 5), (5, 1)):
        step += [_conv(hidden_dim + inp, hidden_dim, kh, kw, h, w)] * 3
    step += [_conv(hidden_dim, 256, 3, 3, h, w), _conv(256, 2, 3, 3, h, w)]
    items += step * iters
    items += [_conv(hidden_dim, 256, 3, 3, h, w), _conv(256, 64 * 9, 1, 1, h, w)]
    items.append((2.0 * 9 * 64 * 2 * n, F32 * (64 * 9 * n + 2 * n + 2 * 64 * n)))
    return sum(f for f, _ in items), sum(b for _, b in items)
