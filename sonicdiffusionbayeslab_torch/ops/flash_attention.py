"""Wrappers of the hand-written CUDA attention kernels.

Two kernels replace the JAX package's Pallas kernels ``_attn_kernel`` and
``_attn_kernel_native`` (``sonicdiffusionbayeslab_tpu/ops/flash_attention.py``),
chosen by dtype alone:

* bfloat16 -> ``flash_attention_sm90`` (``csrc/flash_attention_sm90.cu``):
  wgmma tensor cores and TMA loads, every head_dim that is a multiple of 8
  up to 160 (one instantiation per ``ceil(D / 16)``);
* float32 -> ``flash_attention_fma`` (``csrc/flash_attention.cu``): plain
  fp32 FMA products, exact enough for the fp32 checks, which TF32 tensor
  cores would not pass.

Each of the two takes only its own dtype.

Both read q/k/v through their strides, so the non-contiguous [B, N, H, D]
views of a fused projection go in without a copy; only the head_dim axis
must be contiguous.  The bf16 kernel's TMA loads also need 16-byte aligned
pointers and strides that are multiples of 8 elements
(``tma_layout_error``); the wrapper raises on any other view.

A CPU tensor takes the plain version (``ops.attention.plain_attention``);
a CUDA tensor launches a kernel or raises.  ``flash_attention_sm90.launches``
and ``flash_attention_fma.launches`` count the launches of each kernel.
"""

from __future__ import annotations

import torch

from sonicdiffusionbayeslab_torch.ops import _build

MAX_HEAD_DIM = 160
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
_DTYPES = {torch.bfloat16: "sm90", torch.float32: "fma"}


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel a CUDA call of this dtype launches: "sm90" or "fma"."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")
    return _DTYPES[dtype]


def query_tile_rows(batch: int, heads: int, n: int) -> int:
    """Query rows a block of the bf16 kernel: 128 (two consumer warpgroups)
    where the grid still has a block for every SM, else 64."""
    return 128 if batch * heads * -(-n // 128) >= SM_COUNT else 64


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) strides in elements.  A size-1 axis is never
    stepped along, so it gets the stride a contiguous tensor would have."""
    B, L, H, D = t.shape
    dense = (L * H * D, H * D, D)
    return tuple(s if n > 1 else c for s, n, c in zip(t.stride()[:3], (B, L, H), dense))


def tma_layout_error(t: torch.Tensor) -> str | None:
    """Why a [B, L, H, D] bf16 view cannot be a TMA source, or None: the
    pointer must be 16-byte aligned and each stride a multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return f"data pointer {t.data_ptr():#x} is not 16-byte aligned"
    size = t.element_size()
    bad = [s for s in _tma_strides(t) if (s * size) % 16]
    if bad:
        return f"strides {t.stride()} are not multiples of 16 bytes"
    return None


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
    if N == 0 or M == 0 or B == 0 or H == 0:
        raise ValueError("empty attention")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("head_dim must be the contiguous axis of q, k and v")
    if any(t.device.type != "cuda" or t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one CUDA device")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bf16 wgmma/TMA kernel on CUDA tensors."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_sm90 takes bfloat16, not {q.dtype}")
    for name, t in zip("qkv", (q, k, v)):
        why = tma_layout_error(t)
        if why:
            raise ValueError(f"flash_attention_sm90: {name} cannot be loaded by TMA: {why}")
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        err = lib.sdbl_flash_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N, M, H, D,
            *_tma_strides(q), *_tma_strides(k), *_tma_strides(v), *_strides(o),
            float(D) ** -0.5, query_tile_rows(B, H, N), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_sm90")
    flash_attention_sm90.launches += 1
    return o


def flash_attention_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fp32-FMA kernel on CUDA tensors."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_fma takes float32, not {q.dtype}")
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        err = lib.sdbl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N, M, H, D,
            *_strides(q, k, v, o), float(D) ** -0.5, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_fma")
    flash_attention_fma.launches += 1
    return o


flash_attention_sm90.launches = 0
flash_attention_fma.launches = 0
_KERNELS = {"sm90": flash_attention_sm90, "fma": flash_attention_fma}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D] in q's dtype; fp32 softmax."""
    if q.device.type == "cpu":
        from sonicdiffusionbayeslab_torch.ops.attention import plain_attention

        return plain_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    return _KERNELS[kernel_for(q.dtype)](q, k, v)
