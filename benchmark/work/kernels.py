"""Operations and bytes of the port's hand-written kernels at given
shapes, and the launches a model call makes of each, reckoned from the
configuration and the call's shapes.

A kernel's work is what its algorithm needs, whatever implements it:
every input read once and every output written once, in bf16 (2 bytes),
and the products' multiply-adds as 2 operations each. The FF's LayerNorm
and GELU and the softmax's exponentials are left out of the operations
(under 1 % of the products at these widths).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16 = 2
Work = Tuple[float, float]  # (operations, bytes)


def flash(b: int, h: int, sq: int, sk: int, d: int) -> Work:
    """Kernel A / A': softmax(q k^T) v over (B, H, S, d)."""
    return 4.0 * b * h * sq * sk * d, BF16 * b * h * d * (2 * sq + 2 * sk)


def geglu_ff(rows: int, c: int, inner: int) -> Work:
    """Kernel B: x + W2 (h * gelu(gate)), [h | gate] = W1 LN(x) + b1."""
    flops = 2.0 * rows * c * 2 * inner + 2.0 * rows * inner * c
    weights = c * 2 * inner + 2 * inner + inner * c + c + 2 * c
    return flops, BF16 * (2 * rows * c + weights)


def temporal(n: int, f: int, heads: int, e: int) -> Work:
    """Kernel C: per (pixel, head), softmax over the F frames."""
    return 4.0 * n * heads * f * f * e, BF16 * 4 * n * f * heads * e


def unet3d_launches(cfg: dict, batch: int, frames: int, h: int, w: int,
                    flash_min_seq: int = 256) -> Dict[str, List[Work]]:
    """The work of each launch of kernels A, B and C in one call of the
    InsV2V UNet3D on (batch, frames, h, w) latents: A for spatial
    self-attention at S >= ``flash_min_seq`` positions, B for every spatial
    and motion FF, C twice in every motion module."""
    ch = cfg["block_out_channels"]
    heads, mheads = cfg["attention_head_dim"], cfg["motion_num_attention_heads"]
    n = len(ch)
    out: Dict[str, List[Work]] = {"flash": [], "ff": [], "temporal": []}
    motion = lambda level: cfg["use_motion_module"] and 2 ** level in cfg["motion_module_resolutions"]
    bf = batch * frames

    def level(lvl: int, cross: bool, mm: bool, count: int):
        c, s = ch[lvl], (h >> lvl) * (w >> lvl)
        for _ in range(count):
            if cross:
                if s >= flash_min_seq:
                    out["flash"].append(flash(bf, heads, s, s, c // heads))
                out["ff"].append(geglu_ff(bf * s, c, 4 * c))
            if mm:
                out["ff"].append(geglu_ff(bf * s, c, 4 * c))
                for _ in cfg["motion_attention_block_types"]:
                    out["temporal"].append(temporal(batch * s, frames, mheads, c // mheads))

    for i, kind in enumerate(cfg["down_block_types"]):
        level(i, kind.startswith("CrossAttn"), motion(i), cfg["layers_per_block"])
    level(n - 1, True, False, 1)  # the mid block's transformer
    for i, kind in enumerate(cfg["up_block_types"]):
        level(n - 1 - i, kind.startswith("CrossAttn"), motion(n - 1 - i),
              cfg["layers_per_block"] + 1)
    return out


def unetsd_launches(cfg: dict, batch: int, frames: int, h: int, w: int,
                    flash_min_seq: int = 256) -> Dict[str, List[Work]]:
    """The work of each launch of kernel A in one call of ModelScope's
    UNetSD on (batch, frames, h, w) latents: the spatial self-attention at
    S >= ``flash_min_seq`` positions, heads of ``head_dim``, in every
    block of an attention scale (the temporal and cross-attention take the
    plain path; the model has no kernel B or C)."""
    out: Dict[str, List[Work]] = {"flash": []}
    dim, hd, nres = cfg["dim"], cfg["head_dim"], cfg["num_res_blocks"]
    for lvl, m in enumerate(cfg["dim_mult"]):
        s, c = (h >> lvl) * (w >> lvl), dim * m
        if 0.5 ** lvl in cfg["attn_scales"] and s >= flash_min_seq:
            # the level's input blocks, then its output blocks (one more)
            out["flash"] += [flash(batch * frames, c // hd, s, s, hd)] * (2 * nres + 1)
    return out
