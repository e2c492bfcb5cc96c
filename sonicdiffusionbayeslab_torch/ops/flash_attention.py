"""Wrapper of the hand-written CUDA attention kernel (``csrc/flash_attention.cu``).

It replaces the JAX package's Pallas kernels ``_attn_kernel`` and
``_attn_kernel_native`` (``sonicdiffusionbayeslab_tpu/ops/flash_attention.py``).
The kernel reads q/k/v through their strides, so the non-contiguous
[B, N, H, D] views of a fused projection go in without a copy; only the
head_dim axis must be contiguous.

A CPU tensor takes the plain version (``ops.attention.plain_attention``);
a CUDA tensor launches the kernel or raises.  ``flash_attention.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from sonicdiffusionbayeslab_torch.ops import _build

MAX_HEAD_DIM = 160
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected [B, N, H, D] tensors, got {q.shape}, {k.shape}, {v.shape}")
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != (B, M, H, D):
        raise ValueError(f"kv shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}/{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} must be a multiple of 8 and at most {MAX_HEAD_DIM}")
    if N == 0 or M == 0:
        raise ValueError("empty sequence")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("head_dim must be the contiguous axis of q, k and v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D] in q's dtype; fp32 softmax."""
    if q.device.type == "cpu":
        from sonicdiffusionbayeslab_torch.ops.attention import plain_attention

        return plain_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    _check(q, k, v)
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdbl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, N, M, H, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(D) ** -0.5, _DTYPES[q.dtype], stream,
        )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
