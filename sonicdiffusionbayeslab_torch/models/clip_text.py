"""CLIP text encoders (SD-1.5's ViT-L/14 text tower, SD-2.x's OpenCLIP
ViT-H and SDXL's OpenCLIP bigG) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/clip_text.py``: pre-LN
transformer with a causal mask and quick-GELU (exact GELU in the OpenCLIP
towers), then a final LayerNorm; SD-1.5 and SD-2.1 condition on the last
hidden state, SDXL on both towers' penultimate states (the last layer's
input), and the CLIP score and SDXL's text_time conditioning on the pooled
output (the hidden state at each sequence's end-of-text token).
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

    @classmethod
    def sd21(cls) -> "CLIPTextConfig":
        """SD-2.1's tower: OpenCLIP ViT-H trimmed to 23 layers
        (stable-diffusion-2-1 text_encoder/config.json); the checkpoint
        already ends at the penultimate layer, so the UNet takes the last
        hidden state."""
        return cls(hidden_size=1024, num_layers=23, num_heads=16, intermediate_size=4096,
                   hidden_act="gelu")

    @classmethod
    def tiny21(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, hidden_act="gelu")

    @classmethod
    def sdxl_g(cls) -> "CLIPTextConfig":
        """SDXL's second tower: OpenCLIP ViT-bigG's text model
        (stable-diffusion-xl-base-1.0 text_encoder_2/config.json)."""
        return cls(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
                   hidden_act="gelu")

    @classmethod
    def tiny_g(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                   intermediate_size=32, hidden_act="gelu")


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
        return self.outputs(input_ids)["last_hidden_state"]

    def outputs(self, input_ids: torch.Tensor) -> dict:
        """input_ids [B, T] -> ``last_hidden_state`` [B, T, C],
        ``penultimate_hidden_state`` [B, T, C] (the last layer's input,
        un-normed) and ``pooled_output`` [B, C] (``last_hidden_state`` at the
        end-of-text token), all fp32."""
        T = input_ids.shape[1]
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:T]
        causal = torch.ones(T, T, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        *head, last = self.encoder.layers
        for layer in head:
            x = layer(x, causal)
        penultimate = x.float()
        x = self.final_layer_norm(last(x, causal)).float()
        return {"last_hidden_state": x, "penultimate_hidden_state": penultimate,
                "pooled_output": eot_pooled(x, input_ids)}


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

    def outputs(self, input_ids: torch.Tensor) -> dict:
        """The JAX tower's three outputs (``CLIPTextTransformer.outputs``)."""
        return self.text_model.outputs(input_ids)


class CLIPTextModelWithProjection(CLIPTextModel):
    """transformers' ``CLIPTextModelWithProjection`` (SDXL's
    ``text_encoder_2``): the tower and a bias-free ``text_projection`` of
    the pooled output."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__(config)
        self.text_projection = nn.Linear(config.hidden_size, config.hidden_size, bias=False)
