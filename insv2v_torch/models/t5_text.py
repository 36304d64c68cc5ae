"""T5 v1.1 text encoder, ``ClassEmbedder`` and ``ClipT5Encoder`` as torch
modules.

Counterpart of ``models/t5_text.py`` in the JAX package: the reference's
auxiliary conditioning encoders (``modules/openclip/modules.py``):
``FrozenT5Embedder`` (HF ``T5EncoderModel``, google/t5-v1_1-large),
``ClassEmbedder`` and ``FrozenCLIPT5Encoder``. None of the four workloads
uses them (the edit conditions on CLIP ViT-L alone); they complete the
reference's encoder surface.

``T5TextEncoder`` keeps HF ``T5EncoderModel``'s key layout (``shared``,
``encoder.block.N.layer.{0,1}...``, ``encoder.final_layer_norm``), so a
real google/t5-v1_1-large state dict loads with ``load_state_dict``, the
tied ``encoder.embed_tokens.weight`` included (one tensor under both
names, as in HF). The v1.1 architecture:

  * RMSNorm (no mean subtraction, no bias) before each residual branch;
  * the relative position bias: bucketed (32 buckets, max distance 128),
    one value per head, computed by block 0 and shared by every block;
  * attention scores NOT scaled by 1/sqrt(d_kv); scores, bias and softmax
    in float32, plain PyTorch (the JAX package leaves this op to XLA);
  * the gated tanh-GELU feed-forward (``wi_0`` gated, ``wi_1`` linear,
    ``wo`` out), no biases anywhere;
  * no attention mask: padding tokens are attended, as in the reference.

Dtype: the RMSNorm follows the JAX package, not HF. Its output is
``(weight * x * rsqrt(var + eps))`` in float32 whatever the input's dtype
(the JAX ``.astype(x.dtype)`` reads the already promoted ``x``), where HF
rounds to the weight's dtype. So a bf16 encoder returns float32 hidden
states; every projection casts its input to the weights' dtype first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from insv2v_torch._device import resolve_device
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.ops.attention import attention

__all__ = ["T5Config", "T5TextEncoder", "ClassEmbedder", "ClipT5Encoder",
           "relative_position_bucket", "build_t5_encoder", "build_clip_t5_encoder"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6

    @classmethod
    def v1_1_large(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        """The JAX package's fixture-sized config, for CPU tests."""
        return cls(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing of ``memory - query`` positions, as the
    JAX package computes it (float32 logarithms, +1e-6 inside the log)."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5LayerNorm(nn.Module):
    """RMSNorm; float32 out (the module docstring's dtype note)."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return self.weight.float() * (x.float() * torch.rsqrt(var + self.eps))


def _linear(layer: nn.Linear, x):
    return layer(x.to(layer.weight.dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def forward(self, x, position_bias):
        b, l, _ = x.shape
        split = lambda t: t.reshape(b, l, self.heads, self.d_kv).transpose(1, 2)
        q, k, v = (split(_linear(p, x)) for p in (self.q, self.k, self.v))
        o = attention(q, k, v, scale=1.0, bias=position_bias)
        return _linear(self.o, o.transpose(1, 2).reshape(b, l, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return _linear(self.wo, F.gelu(_linear(self.wi_0, h), approximate="tanh")
                       * _linear(self.wi_1, h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_attention_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5TextEncoder(nn.Module):
    """input_ids (B, L) integer -> last hidden state (B, L, d_model), float32
    (``T5EncoderModel.last_hidden_state``)."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, self.shared)  # tied: one tensor, two keys

    def position_bias(self, length: int, device) -> torch.Tensor:
        """(1, heads, L, L) float32: block 0's bias table at the bucketed
        ``memory - query`` positions."""
        cfg = self.cfg
        pos = torch.arange(length, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        return table(buckets).float().permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids.long())
        bias = self.position_bias(input_ids.shape[1], input_ids.device)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


class ClassEmbedder(nn.Module):
    """Class conditioning: an int class id -> (B, 1, embed_dim), with the
    unconditional-guidance dropout to the last class (``ucg_rate``), drawn
    from the caller's ``torch.Generator``."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, ucg_rate: float = 0.1):
        super().__init__()
        self.n_classes, self.ucg_rate = n_classes, ucg_rate
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, class_ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                disable_dropout: bool = False) -> torch.Tensor:
        c = class_ids[:, None].long()
        if self.ucg_rate > 0.0 and not disable_dropout:
            if generator is None:
                raise ValueError("ucg dropout needs a generator (or disable_dropout=True)")
            keep = torch.rand(c.shape, generator=generator, device=c.device) < 1.0 - self.ucg_rate
            c = torch.where(keep, c, self.n_classes - 1)
        return self.embedding(c)

    def unconditional_ids(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.full((batch_size,), self.n_classes - 1, dtype=torch.long, device=device)


class _Frozen(nn.Module):
    """The reference's ``Frozen*Embedder`` shell: the model as ``transformer``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.transformer = model

    def forward(self, ids):
        return self.transformer(ids)


class ClipT5Encoder(nn.Module):
    """``FrozenCLIPT5Encoder``: the same text, tokenized for each, through a
    CLIP text tower and a T5 encoder -> ``[clip_z, t5_z]``. Keys as the
    reference's: ``clip_encoder.transformer.text_model.*``,
    ``t5_encoder.transformer.*``."""

    def __init__(self, clip: ClipTextEncoder, t5: T5TextEncoder):
        super().__init__()
        self.clip_encoder, self.t5_encoder = _Frozen(clip), _Frozen(t5)

    def forward(self, clip_ids: torch.Tensor, t5_ids: torch.Tensor) -> List[torch.Tensor]:
        return [self.clip_encoder(clip_ids), self.t5_encoder(t5_ids)]


def build_t5_encoder(cfg: T5Config = T5Config.v1_1_large(), *, device=None,
                     dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> T5TextEncoder:
    """A ``T5TextEncoder`` with random weights from ``seed``, made on
    ``device`` (default ``cuda``; raises without a GPU) and cast to
    ``dtype``; load real weights with ``load_state_dict``."""
    dev = resolve_device(device)
    torch.manual_seed(seed)
    with torch.device(dev):
        return T5TextEncoder(cfg).to(dtype).eval()


def build_clip_t5_encoder(clip_cfg: ClipTextConfig = ClipTextConfig.vit_l_14(),
                          t5_cfg: T5Config = T5Config.v1_1_large(), *, device=None,
                          dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> ClipT5Encoder:
    """``ClipT5Encoder`` over the ViT-L/14 text tower and T5 v1.1-large, as
    ``build_t5_encoder`` makes them."""
    dev = resolve_device(device)
    torch.manual_seed(seed)
    with torch.device(dev):
        return ClipT5Encoder(ClipTextEncoder(clip_cfg), T5TextEncoder(t5_cfg)).to(dtype).eval()
