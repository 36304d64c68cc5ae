"""Directional CLIP similarity: the LOVEU-TGVE score of an edit.

Counterpart of ``utils/clip_metrics.py`` in the JAX package, on the port's
CLIP towers (ViT-L/14 image tower, the text tower of ``clip_text.py``):

  sim_0         = cos(image_0, text_0)
  sim_1         = cos(image_1, text_1)
  sim_direction = cos(image_1 - image_0, text_1 - text_0)
  sim_image     = cos(image_0, image_1)

Image features are the post-LN class token through the visual projection;
text features the final-LN hidden state at the first end-of-text token
(the largest id, so ``argmax``) through the text projection. The towers
run in float32 on the port's device (``cuda`` unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from insv2v_torch._device import resolve_device
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.clip_vision import (ClipTextProjection, ClipVisionConfig,
                                             ClipVisionEncoder, ClipVisionProjection,
                                             preprocess_frames)

__all__ = ["cosine", "clip_models", "ClipSimilarity"]

# the HF CLIPModel key prefix of each tower
_PREFIXES = {"text": "text_model.", "vision": "vision_model.",
             "visual_projection": "visual_projection.", "text_projection": "text_projection."}


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    norm = lambda x: x / (x.norm(dim=-1, keepdim=True) + eps)
    return (norm(a) * norm(b)).sum(dim=-1)


def clip_models(text_cfg: Optional[ClipTextConfig] = None,
                vision_cfg: Optional[ClipVisionConfig] = None,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0) -> Dict[str, torch.nn.Module]:
    """{'text', 'vision', 'visual_projection', 'text_projection'} (ViT-L/14
    by default) on the CPU in float32, seeded random, then loaded from a HF
    ``CLIPModel`` ``state_dict`` when one is given (every tower's keys
    required, none unknown)."""
    text_cfg = text_cfg or ClipTextConfig.vit_l_14()
    vision_cfg = vision_cfg or ClipVisionConfig.vit_l_14()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        models = {
            "text": ClipTextEncoder(text_cfg),
            "vision": ClipVisionEncoder(vision_cfg),
            "visual_projection": ClipVisionProjection(vision_cfg.hidden_size,
                                                      vision_cfg.projection_dim),
            "text_projection": ClipTextProjection(text_cfg.hidden_size,
                                                  vision_cfg.projection_dim),
        }
    if state_dict is not None:
        known = set()
        for name, module in models.items():
            sub = {k: v for k, v in state_dict.items() if k.startswith(_PREFIXES[name])}
            module.load_state_dict(sub, strict=True)
            known |= set(sub)
        unknown = sorted(set(state_dict) - known)
        if unknown:
            raise ValueError(f"CLIP state dict: keys no tower has: {unknown[:5]}")
    return models


class ClipSimilarity:
    """The four scores of two frame sets against two captions.

    ``models``: the towers of ``clip_models``; ``tokenizer``:
    callable(list[str]) -> (B, 77) ids."""

    def __init__(self, models: Mapping[str, torch.nn.Module], tokenizer=None, device=None):
        self.device = resolve_device(device)
        self.models = {k: m.to(self.device, torch.float32).eval() for k, m in models.items()}
        if tokenizer is None:
            from insv2v_torch.text.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        self.image_size = self.models["vision"].cfg.image_size

    @torch.no_grad()
    def image_features(self, frames) -> torch.Tensor:
        """frames (N, H, W, 3) in [-1, 1] -> (N, projection_dim)."""
        x = preprocess_frames(torch.as_tensor(np.asarray(frames), device=self.device),
                              self.image_size)
        return self.models["visual_projection"](self.models["vision"](x))

    @torch.no_grad()
    def text_features(self, texts: List[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.tokenizer(texts)), device=self.device)
        hidden = self.models["text"](ids)
        pooled = hidden[torch.arange(ids.shape[0], device=self.device), ids.argmax(dim=-1)]
        return self.models["text_projection"](pooled)

    def __call__(self, frames_0, frames_1, text_0: List[str],
                 text_1: List[str]) -> Dict[str, np.ndarray]:
        """frames (N, H, W, 3) in [-1, 1]; one caption each, broadcast over
        the N frames. Returns each score per frame, (N,)."""
        i0, i1 = self.image_features(frames_0), self.image_features(frames_1)
        t0, t1 = self.text_features(text_0), self.text_features(text_1)
        scores = {"sim_0": cosine(i0, t0), "sim_1": cosine(i1, t1),
                  "sim_direction": cosine(i1 - i0, t1 - t0), "sim_image": cosine(i0, i1)}
        return {k: v.cpu().numpy() for k, v in scores.items()}
