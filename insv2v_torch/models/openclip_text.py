"""OpenCLIP text transformer (the ViT-H/14 text tower, penultimate layer)
as torch modules: the conditioning encoder of ModelScope data generation.

Counterpart of ``models/openclip_text.py`` in the JAX package (the
reference's ``FrozenOpenCLIPEmbedder``): token and positional embedding,
pre-LN residual blocks with a causal additive mask, exact (erf) GELU, run
to the penultimate block, then ``ln_final``; returns the (B, 77, width)
hidden sequence. Keys follow open_clip (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.N.attn.in_proj_weight``,
``...ln_1``, ``...mlp.c_fc``, ``ln_final``), and every one of the tower's
``num_layers`` blocks is built, the last unused, so a real ViT-H/14 text
tower loads with ``load_state_dict`` (see ``openclip_text_state_dict``).
The 77-token attention takes the plain path; the LayerNorms go through
``ops.norms.layer_norm`` (kernel D when ``INSV2V_PALLAS_NORM`` is on).

SDXL's second tower (ViT-bigG/14: width 1280, 32 layers, 20 heads) is the
same module with ``final_norm=False`` (the penultimate state as it is,
sgm's ``FrozenOpenCLIPEmbedder2``) and ``projection_dim``: then every
block runs, and the call also returns the pooled embedding, ``ln_final``
of the last block's state at the end token (the first position of the
largest id) times ``text_projection`` (width, projection_dim).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from insv2v_torch.models.unet3d import LayerNorm
from insv2v_torch.ops.attention import attention

__all__ = ["OpenClipTextConfig", "OpenClipTextEncoder", "openclip_text_state_dict"]


@dataclasses.dataclass(frozen=True)
class OpenClipTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    max_positions: int = 77
    penultimate: bool = True  # run num_layers - 1 blocks (layer='penultimate')
    final_norm: bool = True  # ln_final on the returned sequence
    projection_dim: int = 0  # > 0: also return the pooled, projected embedding

    @classmethod
    def vit_h_14(cls) -> "OpenClipTextConfig":
        return cls()


class PackedSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed q/k/v projection)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask):
        b, s, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads).transpose(1, 2)
        o = attention(split(q), split(k), split(v), bias=mask)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(d, hidden)
        self.c_proj = nn.Linear(hidden, d)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualBlock(nn.Module):
    def __init__(self, cfg: OpenClipTextConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width)
        self.attn = PackedSelfAttention(cfg.width, cfg.num_heads)
        self.ln_2 = LayerNorm(cfg.width)
        self.mlp = _Mlp(cfg.width, cfg.width * cfg.mlp_ratio)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: OpenClipTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualBlock(cfg) for _ in range(cfg.num_layers)])


class OpenClipTextEncoder(nn.Module):
    """ids (B, S <= 77) -> hidden states after the penultimate block and
    ``ln_final``, (B, S, width)."""

    def __init__(self, cfg: OpenClipTextConfig = OpenClipTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.randn(cfg.max_positions, cfg.width) * 0.01)
        self.transformer = _Transformer(cfg)
        self.ln_final = LayerNorm(cfg.width)
        if cfg.projection_dim:
            self.text_projection = nn.Parameter(
                torch.randn(cfg.width, cfg.projection_dim) * cfg.width ** -0.5)

    def forward(self, input_ids: torch.Tensor):
        """The sequence, or (sequence, pooled) with ``projection_dim``."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids.long()) + self.positional_embedding[:s]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        n_blocks = cfg.num_layers - (1 if cfg.penultimate else 0)
        for block in self.transformer.resblocks[:n_blocks]:
            x = block(x, mask)
        seq = self.ln_final(x) if cfg.final_norm else x
        if not cfg.projection_dim:
            return seq
        for block in self.transformer.resblocks[n_blocks:]:
            x = block(x, mask)
        eot = input_ids.argmax(dim=-1)
        pooled = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        return seq, pooled @ self.text_projection.to(pooled.dtype)


_TOWER_KEYS = ("token_embedding.", "positional_embedding", "transformer.resblocks.", "ln_final.")


def openclip_text_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An open_clip checkpoint (the whole CLIP model, or its text tower,
    with or without a ``model.`` prefix) -> the text tower's keys, which
    ``OpenClipTextEncoder.load_state_dict`` takes."""
    out = {}
    for k, v in sd.items():
        k = k[len("model."):] if k.startswith("model.") else k
        if k.startswith(_TOWER_KEYS):
            out[k] = v
    return out
