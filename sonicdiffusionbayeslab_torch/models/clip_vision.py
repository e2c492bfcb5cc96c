"""CLIP vision tower (ViT) and the CLIP dual encoder of the CLIP score.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/clip_vision.py``:
images are normalised with CLIP's mean and std, resized to the tower's
input size, cut into patches, and run through a pre-LN transformer whose
class-token output, projected and L2-normalised, meets the projected text
embedding; score = max(0, 100 * cosine).  Parameter names follow
transformers' ``CLIPModel`` (``vision_model.*``, ``text_model.*``,
``visual_projection``, ``text_projection``), so a checkpoint of it loads
by name.

The vision tower's self-attention is unmasked, so ``ops.attention``
sends it to the hand-written kernel; in fp32 (the metric's type) that is
the split-TF32 kernel, at [B, 197, 12, 64] for ViT-B/16 at 224x224.

The resize: ``jax.image.resize(..., "bilinear")`` antialiases when it
shrinks; ``F.interpolate(mode="bilinear", antialias=True,
align_corners=False)`` computes the same triangle filter.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.models.clip_text import (
    CLIPEncoder,
    CLIPTextConfig,
    CLIPTextTransformer,
    eot_pooled,
)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults = openai/clip-vit-base-patch16 vision tower."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


# openai/clip-vit-base-patch16's text tower (not SD's ViT-L text tower).
CLIP_B16_TEXT = CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8,
                               intermediate_size=2048)

_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, H, W] -> tokens [B, 1 + patches, C]."""
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls_tok = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls_tok, x], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]]


class CLIPVisionTransformer(nn.Module):
    """transformers' ``CLIPVisionTransformer`` (``vision_model``)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)  # transformers' spelling
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                                   cfg.intermediate_size)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised pixels [B, 3, S, S] -> pooled class token [B, C]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)), None)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision_model(pixels)


def clip_pixels(images: torch.Tensor, size: int) -> torch.Tensor:
    """Images [B, H, W, 3] in [0, 1] -> CLIP-normalised [B, 3, size, size]
    (normalised first, then resized with an antialiased bilinear filter
    when the size differs, as the JAX package does)."""
    # Channel by channel with Python scalars: no host-to-device copy, so the
    # call can be captured in a CUDA graph.
    x = torch.stack([(images[..., c] - m) / sd for c, (m, sd) in enumerate(zip(_MEAN, _STD))], 1)
    if x.shape[-2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", antialias=True,
                          align_corners=False)
    return x


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


class CLIPDualEncoder(nn.Module):
    """Full CLIP: vision and text towers, projections to the shared space."""

    def __init__(self, vision_config: CLIPVisionConfig, text_config: CLIPTextConfig,
                 projection_dim: int = 512):
        super().__init__()
        self.vision_config = vision_config
        self.text_config = text_config
        self.vision_model = CLIPVisionTransformer(vision_config)
        self.text_model = CLIPTextTransformer(text_config)
        self.visual_projection = nn.Linear(vision_config.hidden_size, projection_dim, bias=False)
        self.text_projection = nn.Linear(text_config.hidden_size, projection_dim, bias=False)

    def embed_image(self, images: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, 3] in [0, 1] -> L2-normalised [B, P]."""
        pooled = self.vision_model(clip_pixels(images, self.vision_config.image_size))
        return _l2_normalise(self.visual_projection(pooled).float())

    def embed_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        pooled = eot_pooled(self.text_model(input_ids), input_ids)
        return _l2_normalise(self.text_projection(pooled).float())

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP score per (image, prompt) pair: max(0, 100 * cosine)."""
        vi = self.embed_image(images)
        vt = self.embed_text(input_ids)
        return torch.clamp_min(100.0 * (vi * vt).sum(-1), 0.0)
