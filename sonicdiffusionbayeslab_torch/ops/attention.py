"""Attention dispatch for the port: [B, N, H, D] queries over [B, M, H, D]
keys and values.

The rule is static.  An unmasked call whose head_dim the CUDA kernels take
(a multiple of 8, at most 160) goes to ``flash_attention``; that covers
every self- and cross-attention of the UNet.  There the dtype alone picks
the kernel: bfloat16 goes to the wgmma/TMA kernel
(``csrc/flash_attention_sm90.cu``, instantiated for every such head_dim),
float32 to the split-TF32 mma.sync kernel (``csrc/flash_attention.cu``,
one instantiation per such head_dim); no call falls back
from one to the other.  A masked call (CLIP's causal mask) and the VAE's
single-head D=512 mid-block attention take the plain path, as the JAX
reference sends them to XLA.

With grad mode on and an input that requires grad, ``flash_attention``
itself goes through its autograd Function (``FlashAttentionFn``).
"""

from __future__ import annotations

import torch

from sonicdiffusionbayeslab_torch.ops.flash_attention import MAX_HEAD_DIM, flash_attention


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Reference math (the JAX package's ``_xla_attention``): fp32 logits and
    softmax, probabilities cast to ``q.dtype`` before the AV product.
    ``mask`` is boolean, broadcastable to [B, H, N, M], True = attend."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def uses_kernel(q: torch.Tensor, mask=None) -> bool:
    d = q.shape[-1]
    return mask is None and d <= MAX_HEAD_DIM and d % 8 == 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Heads-separate attention: q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D]."""
    if uses_kernel(q, mask):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, mask)
