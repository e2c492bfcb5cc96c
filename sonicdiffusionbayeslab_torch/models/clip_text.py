"""CLIP text encoder (ViT-L/14 text tower, SD-1.5's conditioner) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/clip_text.py``: pre-LN
transformer with a causal mask and quick-GELU, then a final LayerNorm; SD
conditions on the last hidden state [B, 77, 768], and the CLIP score on the
pooled output (the hidden state at each sequence's end-of-text token).
Parameter names follow transformers' ``CLIPTextModel``
(``text_model.encoder.layers.{i}...``).  The causal mask sends attention
down the plain path.  ``CLIPLayer`` is built from widths, so that the
vision tower (``clip_vision.py``) uses it too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)

    @classmethod
    def sd15(cls) -> "CLIPTextConfig":
        return cls()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        shape = (B, T, self.num_heads, C // self.num_heads)
        q, k, v = (p(x).view(shape) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(dot_product_attention(q, k, v, mask=mask).reshape(B, T, C))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)
        self.act = quick_gelu if act == "quick_gelu" else F.gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 act: str = "quick_gelu"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, intermediate_size, act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, dim: int, num_layers: int, num_heads: int, intermediate_size: int,
                 act: str = "quick_gelu"):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(dim, num_heads, intermediate_size, act)
                                     for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class CLIPTextTransformer(nn.Module):
    """transformers' ``CLIPTextTransformer``: the ``text_model`` of a
    ``CLIPTextModel`` or of a dual encoder."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                                   cfg.intermediate_size, cfg.hidden_act)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T] -> last_hidden_state [B, T, C] in fp32."""
        T = input_ids.shape[1]
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:T]
        causal = torch.ones(T, T, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        return self.final_layer_norm(self.encoder(x, causal)).float()


def eot_pooled(hidden: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """The hidden state at each sequence's end-of-text token, which has the
    highest id of CLIP's vocabulary (the first such position)."""
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), input_ids.argmax(-1)]


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T] -> last_hidden_state [B, T, C] in fp32."""
        return self.text_model(input_ids)
