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

The backend selector takes the JAX package's names
(``set_attention_backend``: None, ``xla``, ``pallas``, ``tiered``; else
``SDBL_ATTENTION``) and refuses any other, from either source.  ``xla``
sends every call to ``plain_attention``; ``pallas``, ``tiered`` and None
(the default) keep the static rule above: there is one kernel for each
dtype, so the TPU's tiers have no counterpart, and the selector keeps one
bit.  The backend is resolved at the entry points (an engine's
construction and ``sample``, and ``set_attention_backend`` itself), never
inside a forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from sonicdiffusionbayeslab_torch.ops.flash_attention import MAX_HEAD_DIM, flash_attention
from sonicdiffusionbayeslab_torch.utils import env

BACKENDS = (None, "xla", "pallas", "tiered")
_BACKEND = None  # set_attention_backend's choice; None defers to SDBL_ATTENTION
_PLAIN = False  # whether calls take plain_attention, as resolved at the last entry point


def _checked(name: Optional[str], what: str) -> Optional[str]:
    if name not in BACKENDS:
        raise ValueError(f"unknown {what} {name!r}")
    return name


def set_attention_backend(name: Optional[str]) -> None:
    """'xla' | 'pallas' | 'tiered' | None (the variable, else the kernels)."""
    global _BACKEND
    _BACKEND = _checked(name, "attention backend")
    resolve_attention_backend()


def get_attention_backend() -> Optional[str]:
    """The explicit backend, else ``SDBL_ATTENTION``, else None; an unknown
    name in the variable raises, as it does in ``set_attention_backend``."""
    if _BACKEND is not None:
        return _BACKEND
    return _checked(env.attention_backend(), "SDBL_ATTENTION")


def resolve_attention_backend() -> bool:
    """Read :func:`get_attention_backend` into what the calls take (an
    entry point's step); returns whether that is the plain path."""
    global _PLAIN
    _PLAIN = get_attention_backend() == "xla"
    return _PLAIN


def plain_selected() -> bool:
    """Whether the backend resolved at the last entry point is ``xla``."""
    return _PLAIN


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
    if not _PLAIN and uses_kernel(q, mask):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, mask)
