"""Plain float32 reference of RAFT-large (Teed & Deng, "RAFT: Recurrent
All-Pairs Field Transforms for Optical Flow", ECCV 2020, arXiv 2003.12039)
as torchvision's ``raft_large`` computes it: the flow model that InsV2V's
``misc_utils/flow_utils.py::RAFTFlow`` loads for its motion-compensated edit.

Written from the paper and torchvision's ``models/optical_flow/raft.py`` as
functions over a dict of weights under princeton-vl's state-dict keys
(``fnet.*``, ``cnet.*``, ``update_block.*``), in plain torch operations,
NCHW inside; it imports nothing of the program. Images are (N, H, W, 3) in
[-1, 1], H and W multiples of 8; a flow is (N, H, W, 2) = (u, v) in pixels
from image 1 to image 2, float32 (TF32 off: ``ops.strict_fp32``).

  * the feature encoder (instance norm) and the context encoder (frozen
    batch norm): a 7x7 conv at stride 2, three stages of two residual
    blocks at 64 / 96 / 128 channels (strides 1, 2, 2), a 1x1 head to 256;
  * the all-pairs correlation volume <f1, f2> / sqrt(D) at 1/8 resolution,
    average-pooled 2x2 into a pyramid of ``corr_levels`` levels, for a
    block of pairs at a time (``raft_flow``'s ``block``);
  * the lookup: a (2r+1)^2 window at radius ``corr_radius`` around each
    pixel's position, at every level (the position halved a level), by
    ``F.grid_sample`` (bilinear, zeros outside, ``align_corners=True``);
  * the update, ``iters`` times: the motion encoder (correlation -> 256 ->
    192, flow -> 128 -> 64, merged to 126, the flow appended), the
    separable ConvGRU (1x5 then 5x1), the flow head (-> 256 -> 2);
  * the convex 8x upsampling: a softmax over the 9 neighbours of
    0.25 x the mask head's 576 channels from the last hidden state.

The lookup's window order is torchvision's and princeton-vl's: channel
``a*(2r+1) + b`` of a level samples the offset (x, y) = (a - r, b - r), the
x offset on the major index. Departures from torchvision:

  * the mask's 576 channels are read as ``(u*8 + v)*9 + n`` (fine row u and
    column v of a coarse cell, neighbour n of the 3x3, row-major), the
    order of the JAX package's RAFT; torchvision and princeton-vl read
    ``n*64 + u*8 + v``. The program's ``load_raft_state_dict`` loads their
    checkpoints through its ``mask_order="princeton-vl"`` permutation;
  * each pyramid level is zero-padded by one pixel before it is sampled,
    which leaves the samples as they are and gives a level one pixel wide
    (a 64 x 64 image's fourth) the same zeros outside, where torchvision's
    normalisation divides by its width - 1; a level pools an axis of one
    pixel with a window of one.

``rounded(mode)``: every product's inputs rounded, and summed in float32.
``torch.bfloat16`` rounds the inputs of the convolutions and of the
volume's matrix product: the control, a precision below the float32 the
configuration states. ``"tf32"`` rounds the convolutions' inputs to TF32's
10 mantissa bits (to nearest) and leaves the matrix product in float32:
the precision the configuration states, PyTorch's defaults on the card
(cuDNN's TF32 on, matmul's off), which scales the cell's ``flow`` check.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

_LOW = [None]  # how every product's inputs are rounded; None: float32


@contextlib.contextmanager
def rounded(mode):
    saved, _LOW[0] = _LOW[0], mode
    try:
        yield
    finally:
        _LOW[0] = saved


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away
    from zero on the magnitude)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _q(t: torch.Tensor, conv: bool = True) -> torch.Tensor:
    """A product's input as ``rounded`` has it."""
    t = t.float()
    mode = _LOW[0]
    if mode is None or (mode == "tf32" and not conv):
        return t
    return _tf32(t) if mode == "tf32" else t.to(mode).float()


def _conv(W, p: str, x, stride: int = 1):
    """A conv with 'same' padding for its odd kernel (1x1, 3x3, 7x7, 1x5, 5x1)."""
    w = W[p + ".weight"]
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    return F.conv2d(_q(x), _q(w), W[p + ".bias"].float(), stride, pad)


def _instance_norm(x, eps: float = 1e-5):
    var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _frozen_batch_norm(W, p: str, x, eps: float = 1e-5):
    c = lambda k: W[f"{p}.{k}"].float()[None, :, None, None]
    return (x - c("running_mean")) * torch.rsqrt(c("running_var") + eps) * c("weight") + c("bias")


def _norm(W, p, x, kind):
    return _instance_norm(x) if kind == "instance" else _frozen_batch_norm(W, p, x)


def _residual(W, p: str, x, kind: str, stride: int):
    y = F.relu(_norm(W, p + ".norm1", _conv(W, p + ".conv1", x, stride), kind))
    y = F.relu(_norm(W, p + ".norm2", _conv(W, p + ".conv2", y), kind))
    if p + ".downsample.0.weight" in W:
        x = _norm(W, p + ".downsample.1", _conv(W, p + ".downsample.0", x, stride), kind)
    return F.relu(x + y)


def encoder(W, p: str, images, kind: str):
    """images (N, 3, H, W) -> features (N, D, H/8, W/8)."""
    x = F.relu(_norm(W, p + ".norm1", _conv(W, p + ".conv1", images, 2), kind))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        x = _residual(W, f"{p}.layer{layer}.0", x, kind, stride)
        x = _residual(W, f"{p}.layer{layer}.1", x, kind, 1)
    return _conv(W, p + ".conv2", x)


def corr_pyramid(f1, f2, levels: int):
    """f1, f2 (N, D, h, w) -> ``levels`` volumes (N*h*w, 1, h/2^l, w/2^l)."""
    n, d, h, w = f1.shape
    corr = torch.bmm(_q(f1, False).reshape(n, d, h * w).transpose(1, 2),
                     _q(f2, False).reshape(n, d, h * w))
    pyr = [(corr / math.sqrt(d)).reshape(n * h * w, 1, h, w)]
    for _ in range(levels - 1):
        v = pyr[-1]
        k = (min(2, v.shape[2]), min(2, v.shape[3]))
        pyr.append(F.avg_pool2d(v, k, stride=k))
    return pyr


def corr_lookup(pyr, coords, radius: int):
    """coords (N, 2, h, w) = (x, y) at 1/8 resolution -> (N, levels*(2r+1)^2, h, w)."""
    n, _, h, w = coords.shape
    offs = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(offs, offs, indexing="ij"), dim=-1)  # [a, b] = (x, y)
    centre = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    out = []
    for vol in pyr:
        vol = F.pad(vol, (1, 1, 1, 1))
        hv, wv = vol.shape[2:]
        at = centre + delta[None] + 1.0  # the pad's pixel is index 0
        grid = torch.stack([2 * at[..., 0] / (wv - 1) - 1, 2 * at[..., 1] / (hv - 1) - 1], dim=-1)
        out.append(F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True).reshape(n, h, w, -1))
        centre = centre / 2
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def update(W, hidden, context, corr, flow):
    """One refinement -> (hidden, flow delta (N, 2, h, w))."""
    p = "update_block."
    c = F.relu(_conv(W, p + "encoder.convc2", F.relu(_conv(W, p + "encoder.convc1", corr))))
    f = F.relu(_conv(W, p + "encoder.convf2", F.relu(_conv(W, p + "encoder.convf1", flow))))
    motion = torch.cat([F.relu(_conv(W, p + "encoder.conv", torch.cat([c, f], dim=1))), flow], 1)
    x = torch.cat([context, motion], dim=1)
    for s in "12":
        hx = torch.cat([hidden, x], dim=1)
        z = torch.sigmoid(_conv(W, f"{p}gru.convz{s}", hx))
        r = torch.sigmoid(_conv(W, f"{p}gru.convr{s}", hx))
        q = torch.tanh(_conv(W, f"{p}gru.convq{s}", torch.cat([r * hidden, x], dim=1)))
        hidden = (1 - z) * hidden + z * q
    delta = _conv(W, p + "flow_head.conv2", F.relu(_conv(W, p + "flow_head.conv1", hidden)))
    return hidden, delta


def convex_upsample(W, hidden, flow):
    """flow (N, 2, h, w) -> (N, 2, 8h, 8w), each fine pixel a convex
    combination of 8 x the flow at the 3x3 coarse neighbours."""
    n, _, h, w = flow.shape
    mask = 0.25 * _conv(W, "update_block.mask.2", F.relu(_conv(W, "update_block.mask.0", hidden)))
    weights = torch.softmax(mask.reshape(n, 8, 8, 9, h, w), dim=3)
    neigh = F.unfold(8.0 * flow, kernel_size=3, padding=1).reshape(n, 2, 9, h, w)
    up = torch.einsum("nuvkij,nckij->ncuvij", weights, neigh)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def raft_pairs(W, cfg: Dict, im1, im2):
    """RAFT of one block of pairs: im1, im2 (N, H, W, 3) -> flows (N, H, W, 2)."""
    hidden_dim = W["update_block.gru.convz1.weight"].shape[0]
    a = im1.float().permute(0, 3, 1, 2)
    b = im2.float().permute(0, 3, 1, 2)
    f1, f2 = encoder(W, "fnet", torch.cat([a, b]), "instance").chunk(2)
    pyr = corr_pyramid(f1, f2, cfg["corr_levels"])
    cmap = encoder(W, "cnet", a, "batch")
    hidden, context = torch.tanh(cmap[:, :hidden_dim]), F.relu(cmap[:, hidden_dim:])
    n, _, h, w = f1.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=a.device, dtype=torch.float32),
                            torch.arange(w, device=a.device, dtype=torch.float32), indexing="ij")
    coords0 = torch.stack([gx, gy])[None].expand(n, 2, h, w)
    flow = torch.zeros((n, 2, h, w), device=a.device)
    for _ in range(cfg["iters"]):
        corr = corr_lookup(pyr, coords0 + flow, cfg["corr_radius"])
        hidden, delta = update(W, hidden, context, corr, flow)
        flow = flow + delta
    return convex_upsample(W, hidden, flow).permute(0, 2, 3, 1)


def raft_flow(W, cfg: Dict, im1, im2, block: int = 8):
    """RAFT flows of many pairs (N, H, W, 3) -> (N, H, W, 2), ``block``
    pairs at a time (a pair's volume at 384 x 384 is 21 MB)."""
    return torch.cat([raft_pairs(W, cfg, im1[i: i + block], im2[i: i + block])
                      for i in range(0, im1.shape[0], block)])
