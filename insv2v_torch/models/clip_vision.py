"""CLIP vision transformer (ViT-L/14) and the two projection heads, for the
directional CLIP similarity that scores LOVEU-TGVE edits.

Counterpart of ``models/clip_vision.py`` in the JAX package, with the HF
``CLIPModel`` key layout (``vision_model.embeddings.{class_embedding,
patch_embedding, position_embedding}``, ``vision_model.pre_layrnorm`` in
HF's spelling, ``vision_model.encoder.layers.N``,
``vision_model.post_layernorm``, ``visual_projection.weight``,
``text_projection.weight``). Image features are the post-LN class token
through the visual projection. The encoder layers are the text tower's
(``ClipEncoderLayer``), unmasked; at 257 tokens their attention is the
plain op, as in the JAX package (no flash kernel there).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from insv2v_torch.models.clip_text import ClipEncoderLayer, ClipTextConfig
from insv2v_torch.models.unet3d import LayerNorm
from insv2v_torch.ops.resize import bilinear_resize

__all__ = ["CLIP_IMAGE_SIZE", "CLIP_MEAN", "CLIP_STD", "ClipVisionConfig", "ClipVisionEncoder",
           "ClipVisionProjection", "ClipTextProjection", "preprocess_frames"]

# CLIP image preprocessing (openai CLIP's transform)
CLIP_IMAGE_SIZE = 224
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_l_14(cls) -> "ClipVisionConfig":
        return cls()

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    def as_text_like(self) -> ClipTextConfig:
        """The encoder-layer widths in the text tower's config."""
        return ClipTextConfig(vocab_size=1, hidden_size=self.hidden_size,
                              num_layers=self.num_layers, num_heads=self.num_heads,
                              intermediate_size=self.intermediate_size,
                              layer_norm_eps=self.layer_norm_eps)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size) * 0.02)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        layer_cfg = cfg.as_text_like()
        self.layers = nn.ModuleList([ClipEncoderLayer(layer_cfg) for _ in range(cfg.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class ClipVisionEncoder(nn.Module):
    """images (B, 224, 224, 3), CLIP-normalised, channels-last -> pooled
    (B, hidden): the post-LN class token."""

    def __init__(self, cfg: ClipVisionConfig = ClipVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        b = images.shape[0]
        patches = emb.patch_embedding(images.permute(0, 3, 1, 2).to(emb.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # (B, N, hidden), row-major patches
        cls = emb.class_embedding.reshape(1, 1, -1).expand(b, 1, -1).to(patches.dtype)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, None)
        return vm.post_layernorm(x[:, 0])


class ClipVisionProjection(nn.Module):
    def __init__(self, hidden_size: int = 1024, projection_dim: int = 768):
        super().__init__()
        self.visual_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pooled):
        return self.visual_projection(pooled)


class ClipTextProjection(nn.Module):
    def __init__(self, hidden_size: int = 768, projection_dim: int = 768):
        super().__init__()
        self.text_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pooled):
        return self.text_projection(pooled)


def preprocess_frames(frames: torch.Tensor, size: int = CLIP_IMAGE_SIZE) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> CLIP-normalised (N, size, size, 3), float32:
    to [0, 1], bilinear to size x size, then CLIP's mean and std."""
    x = bilinear_resize((frames.float() + 1.0) / 2.0, size, size)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
