"""The T5 v1.1 encoder, SD3's optional third text tower, in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/t5.py`` with the
parameter names of transformers' ``T5EncoderModel`` (google/t5-v1_1-xxl):

* pre-norm residual blocks of self-attention and a gated-GELU feed-forward
  (``wo(gelu_tanh(wi_0 x) * wi_1 x)``), every linear bias-free;
* RMS layer norms with fp32 moments and no mean (``layers.RMSNorm``);
* attention scores unscaled (T5 folds 1/sqrt(d) into its initialisation)
  plus a learned per-head bias of the bucketed relative position, one
  table (block 0's, ``relative_attention_bias``) shared by every layer;
* no attention mask: the padded sequence attends everywhere, as diffusers'
  SD3 text path does.

The attention is stock PyTorch ops, not ``ops.attention``: its scores
carry no 1/sqrt(d) and an additive bias, and the reference sends it to
XLA's plain fusion.  The tower runs once a prompt batch, outside the
denoising loop.  The bucket table is the port's own numpy copy of the
reference's ``relative_position_buckets``.

Under a mesh's ``model`` axis (``parallel.mesh.place_module``) a rank
keeps its heads of q/k/v (and their columns of the relative-position
bias table) and its hidden units of ``wi_0``/``wi_1``; ``o`` and ``wo``
sum their partials across the axis in fp32.  Placed so, the tower stays
resident on the card, never staged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import RMSNorm, keep_slice_, reduce_partial


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 256  # SD3's max_sequence_length of the T5 tokens

    @classmethod
    def xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl's encoder (SD3's text_encoder_3/config.json)."""
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        """CPU-sized geometry; d_model 40 is ``MMDiTConfig.tiny()``'s
        joint_attention_dim."""
        return cls(vocab_size=1000, d_model=40, d_kv=8, d_ff=64, num_layers=2, num_heads=2,
                   relative_attention_num_buckets=8, relative_attention_max_distance=16,
                   max_length=16)


def relative_position_buckets(q_len: int, k_len: int, *, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """[q_len, k_len] int32 bucket ids, transformers'
    ``_relative_position_bucket`` (bidirectional): half the buckets for
    each sign, half of those exact small distances, the rest log-spaced up
    to ``max_distance``."""
    ctx = np.arange(q_len, dtype=np.int64)[:, None]
    mem = np.arange(k_len, dtype=np.int64)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    out += np.where(n < max_exact, n, large)
    return out.astype(np.int32)


class T5SelfAttention(nn.Module):
    par = None
    split = False

    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias_table:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.num_heads % count:
            return {}
        cuts = {f"{name}.weight": keep_slice_(getattr(self, name), "weight", dim, index, count)
                for name, dim in (("q", 0), ("k", 0), ("v", 0), ("o", 1),
                                  ("relative_attention_bias", 1)) if hasattr(self, name)}
        self.num_heads //= count
        self.split = True
        return cuts

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        H, D = self.num_heads, self.d_kv
        q = self.q(x).view(B, T, H, D)
        k = self.k(x).view(B, T, H, D)
        v = self.v(x).view(B, T, H, D)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        probs = torch.softmax(scores + position_bias, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H * D)
        if self.split:
            return reduce_partial(F.linear(o, self.o.weight), None, self.par, o.dtype)
        return self.o(o)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_bias_table)
        self.layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)


class T5DenseGatedGelu(nn.Module):
    par = None
    split = False

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.wo.weight.shape[1] % count:
            return {}
        cuts = {f"{name}.weight": keep_slice_(getattr(self, name), "weight", dim, index, count)
                for name, dim in (("wi_0", 0), ("wi_1", 0), ("wo", 1))}
        self.split = True
        return cuts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        if self.split:
            return reduce_partial(F.linear(h, self.wo.weight), None, self.par, h.dtype)
        return self.wo(h)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedGelu(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, first: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, first), T5LayerFF(cfg)])

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids [B, T] -> last hidden states [B, T, d_model] fp32."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def position_bias(self, T: int, device) -> torch.Tensor:
        """[1, H, T, T] fp32 additive bias from the shared bucket table."""
        cfg = self.config
        buckets = torch.as_tensor(relative_position_buckets(
            T, T, num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance), dtype=torch.long, device=device)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        return table.float()[buckets].permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1], input_ids.device)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x).float()
