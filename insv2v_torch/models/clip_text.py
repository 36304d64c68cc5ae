"""CLIP text transformer (ViT-L/14 text tower) as torch modules.

Counterpart of ``models/clip_text.py`` in the JAX package, with the HF
``CLIPTextModel`` state-dict layout (``text_model.embeddings...``,
``text_model.encoder.layers.N...``, ``text_model.final_layer_norm``).
The editor conditions on the last hidden state over all 77 positions:
causal attention, quick_gelu MLP, final LayerNorm. SDXL's first tower
(``penultimate``) takes the state after the second-to-last layer, without
the final LayerNorm (diffusers' ``hidden_states[-2]``). ``DualTextEncoder`` pairs it with OpenCLIP
ViT-bigG/14 as SDXL conditions: the two sequences concatenated on the
channel axis, and bigG's pooled embedding.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from insv2v_torch.models.unet3d import LayerNorm
from insv2v_torch.ops.attention import attention
from insv2v_torch.utils.tracing import span

__all__ = ["ClipTextConfig", "ClipTextEncoder", "DualTextEncoder"]


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    # the state after num_layers - 1 layers, without the final LayerNorm
    penultimate: bool = False

    @classmethod
    def vit_l_14(cls) -> "ClipTextConfig":
        return cls()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads).transpose(1, 2)
        o = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                      bias=mask)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class ClipMlp(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = ClipAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = ClipMlp(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([ClipEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class ClipTextEncoder(nn.Module):
    """input_ids (B, S <= 77) integer -> last hidden state (B, S, hidden)."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids.long()) + \
            tm.embeddings.position_embedding(pos)[None]
        # causal mask, additive -inf above the diagonal; pad positions stay
        # attended from later positions, as in the reference
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        if self.cfg.penultimate:
            for layer in tm.encoder.layers[:-1]:
                x = layer(x, mask)
            return x
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


class DualTextEncoder(nn.Module):
    """SDXL's text conditioning: ``text_encoder`` (CLIP ViT-L/14) and
    ``text_encoder_2`` (OpenCLIP ViT-bigG/14 with its projection) on the
    same ids -> (context (B, S, D1 + D2), pooled (B, P)). Each tower runs
    inside a span of its own (``text.clip_l``, ``text.openclip_bigg``)."""

    def __init__(self, clip: ClipTextEncoder, openclip: nn.Module):
        super().__init__()
        self.text_encoder = clip
        self.text_encoder_2 = openclip

    def forward(self, input_ids: torch.Tensor):
        with span("text.clip_l"):
            first = self.text_encoder(input_ids)
        with span("text.openclip_bigg"):
            second, pooled = self.text_encoder_2(input_ids)
        return torch.cat([first, second], dim=-1), pooled
