"""Wrappers of the hand-written CUDA attention kernels.

Two kernels replace the JAX package's Pallas kernels ``_attn_kernel`` and
``_attn_kernel_native`` (``sonicdiffusionbayeslab_tpu/ops/flash_attention.py``),
chosen by dtype alone:

* bfloat16 -> ``flash_attention_sm90`` (``csrc/flash_attention_sm90.cu``):
  wgmma tensor cores and TMA loads, every head_dim that is a multiple of 8
  up to 160 (one instantiation per ``ceil(D / 16)``);
* float32 -> ``flash_attention_tf32x3`` (``csrc/flash_attention.cu``):
  mma.sync tensor cores on split TF32 (each operand as a TF32 high and low
  part, three products), exact enough for the fp32 checks, which a single
  TF32 product would not pass; one instantiation per head_dim.

Each of the two takes only its own dtype.

Both read q/k/v through their strides, so the non-contiguous [B, N, H, D]
views of a fused projection go in without a copy; only the head_dim axis
must be contiguous.  Both load rows with 16-byte copies (TMA for bf16,
cp.async for fp32), so pointers must be 16-byte aligned and strides
multiples of 16 bytes (``layout_error``); the wrappers raise on any other
view.

A CPU tensor takes the plain version (``ops.attention.plain_attention``);
a CUDA tensor launches a kernel or raises.  ``flash_attention_sm90.launches``
and ``flash_attention_tf32x3.launches`` count the launches of each kernel.

Gradients: with grad mode on and an input that requires grad,
``flash_attention`` goes through ``FlashAttentionFn`` (on both devices, so
the CPU tests run the backward the card runs), whose forward is the same
kernel or plain call and whose backward is ``attention_vjp``, the port's
copy of the JAX package's reverse-mode rule ``_flash_bwd`` (plain einsums
in fp32 with P recomputed, no Pallas backward kernel there either).
"""

from __future__ import annotations

import torch

from sonicdiffusionbayeslab_torch.ops import _build
from sonicdiffusionbayeslab_torch.utils import profiling

MAX_HEAD_DIM = 160
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
_DTYPES = {torch.bfloat16: "sm90", torch.float32: "tf32x3"}


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel a CUDA call of this dtype launches: "sm90" or "tf32x3"."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")
    return _DTYPES[dtype]


def query_tile_rows(batch: int, heads: int, n: int) -> int:
    """Query rows a block of the bf16 kernel: 128 (two consumer warpgroups)
    where the grid still has a block for every SM, else 64."""
    return 128 if batch * heads * -(-n // 128) >= SM_COUNT else 64


def _copy_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) strides in elements.  A size-1 axis is never
    stepped along, so it gets the stride a contiguous tensor would have."""
    B, L, H, D = t.shape
    dense = (L * H * D, H * D, D)
    return tuple(s if n > 1 else c for s, n, c in zip(t.stride()[:3], (B, L, H), dense))


def layout_error(t: torch.Tensor) -> str | None:
    """Why the kernels' 16-byte copies cannot load a [B, L, H, D] view, or
    None: the pointer must be 16-byte aligned and each stride a multiple of
    16 bytes."""
    if t.data_ptr() % 16:
        return f"data pointer {t.data_ptr():#x} is not 16-byte aligned"
    size = t.element_size()
    bad = [s for s in _copy_strides(t) if (s * size) % 16]
    if bad:
        return f"strides {t.stride()} are not multiples of 16 bytes"
    return None


def _check(q, k, v, name: str, dtype: torch.dtype) -> None:
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
    if q.dtype != dtype:
        raise TypeError(f"{name} takes {str(dtype)[6:]}, not {q.dtype}")
    for which, t in zip("qkv", (q, k, v)):
        why = layout_error(t)
        if why:
            raise ValueError(f"{name}: {which} cannot be loaded by 16-byte copies: {why}")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bf16 wgmma/TMA kernel on CUDA tensors."""
    _check(q, k, v, "flash_attention_sm90", torch.bfloat16)
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        err = lib.sdbl_flash_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N, M, H, D,
            *_copy_strides(q), *_copy_strides(k), *_copy_strides(v), *_strides(o),
            float(D) ** -0.5, query_tile_rows(B, H, N), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_sm90")
    _build.count_launch(flash_attention_sm90)
    _build.add_flops(4 * B * H * N * M * D)  # Q·Kᵀ and P·V
    return o


def flash_attention_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fp32 split-TF32 mma.sync kernel on CUDA tensors."""
    _check(q, k, v, "flash_attention_tf32x3", torch.float32)
    B, N, H, D = q.shape
    M = k.shape[1]
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        err = lib.sdbl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N, M, H, D,
            *_copy_strides(q), *_copy_strides(k), *_copy_strides(v), *_strides(o),
            float(D) ** -0.5, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_tf32x3")
    _build.count_launch(flash_attention_tf32x3)
    _build.add_flops(4 * B * H * N * M * D)  # Q·Kᵀ and P·V
    return o


flash_attention_sm90.launches = 0
flash_attention_tf32x3.launches = 0
_KERNELS = {"sm90": flash_attention_sm90, "tf32x3": flash_attention_tf32x3}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D] in q's dtype; fp32 softmax.

    With grad mode on and an input that requires grad the call goes
    through ``FlashAttentionFn``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v)
    return _flash_attention(q, k, v)


def _flash_attention(q, k, v):
    """The kernel on CUDA tensors, ``plain_attention`` on CPU ones."""
    if q.device.type == "cpu":
        from sonicdiffusionbayeslab_torch.ops.attention import plain_attention

        return plain_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    return _KERNELS[kernel_for(q.dtype)](q, k, v)


# fp32 bytes of one [chunk, N, M] score tensor of attention_vjp at most; a
# call holds about four such tensors at once (P, dP, dS and a temporary).
VJP_SCORE_BYTES = 1 << 30


def _vjp_block(q, k, v, do):
    """The JAX package's ``_flash_bwd`` on one block of [B, *, H, D]:
    P recomputed in fp32, dV = Pᵀ·dO, dS = P ∘ (dP − rowsum(dP ∘ P)),
    dQ = dS·K·D^-½, dK = dSᵀ·Q·D^-½, in fp32."""
    scale = float(q.shape[-1]) ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq, dk, dv


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor):
    """(dq, dk, dv) of softmax(q·kᵀ·D^-½)·v for the cotangent ``do`` [B, N,
    H, D], each in its input's dtype.  The [B, H, N, M] fp32 scores are
    formed a chunk of (batch, head) pairs at a time, at most
    ``VJP_SCORE_BYTES`` each: whole batch rows where a row's heads fit,
    else groups of one row's heads; each pair's gradient is independent of
    the others', so the chunks give the unchunked result."""
    B, N, H, _ = q.shape
    pairs = max(1, VJP_SCORE_BYTES // (4 * N * k.shape[1]))
    if pairs >= B * H:
        grads = _vjp_block(q, k, v, do)
    else:
        grads = tuple(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                      for t in (q, k, v))
        if pairs >= H:
            rows = pairs // H
            cuts = [(slice(b, b + rows), slice(None)) for b in range(0, B, rows)]
        else:
            cuts = [(slice(b, b + 1), slice(h, h + pairs)) for b in range(B)
                    for h in range(0, H, pairs)]
        for b, h in cuts:
            part = _vjp_block(*(t[b, :, h] for t in (q, k, v, do)))
            for out, g in zip(grads, part):
                out[b, :, h] = g
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


class FlashAttentionFn(torch.autograd.Function):
    """The kernel (CUDA) or plain version (CPU) with ``attention_vjp`` as
    its backward: the JAX package's ``_flash_autodiff``.  Saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        with profiling.span("attention.backward"):
            return attention_vjp(*ctx.saved_tensors, do)
