"""GroupNorm (+ optional SiLU) over channels-last activations, with the
hand-written CUDA kernel of ``csrc/groupnorm.cu``.

It replaces the JAX package's Pallas kernel ``_kernel``
(``sonicdiffusionbayeslab_tpu/ops/groupnorm.py``) and, unlike it, is the
port's default GroupNorm: every resnet norm, transformer input norm and
output norm of the UNet and VAE comes here.  The math is that of the JAX
default path (``models/layers.py::GroupNorm``): fp32 statistics, the
variance as the mean of squared deviations, output in x's dtype.

A CPU tensor takes ``plain_group_norm``; a CUDA tensor launches the kernel
or raises.  ``group_norm_silu.launches`` counts calls that launched it (one
per call; the kernel itself is a stats launch and an apply launch).
"""

from __future__ import annotations

import math

import torch

from sonicdiffusionbayeslab_torch.ops import _build

MAX_CHANNELS = 4096
TARGET_BLOCKS = 264  # two blocks per SM of an H100 (132 SMs)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_groups(channels: int, num_groups: int) -> int:
    """The reference's rule: ``gcd(C, G)`` groups when C does not divide by G."""
    return num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)


def plain_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool) -> torch.Tensor:
    """x [B, ..., C] -> GroupNorm(+SiLU) with fp32 two-pass statistics."""
    C = x.shape[-1]
    xf = x.float()
    xg = xf.reshape(x.shape[0], -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def chunking(n_rows: int, batch: int) -> tuple[int, int]:
    """(S, R): the rows of one batch item cut into S chunks of R rows, none
    empty, so that the grid (S, B) holds about ``TARGET_BLOCKS`` blocks."""
    s = min(n_rows, max(1, -(-TARGET_BLOCKS // batch)))
    r = -(-n_rows // s)
    return -(-n_rows // r), r


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """x [B, H, W, C] or [B, N, C] (channels last) -> GroupNorm(+SiLU).

    ``groups`` follows the gcd rule when C does not divide by it."""
    C = x.shape[-1]
    groups = resolve_groups(C, groups)
    if x.device.type == "cpu":
        return plain_group_norm(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(
            f"group_norm_silu takes float32 or bfloat16 x, weight and bias of one dtype, "
            f"got {x.dtype}/{weight.dtype}/{bias.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected [B, ..., C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu's kernel reads contiguous channels-last [B, ..., C] "
                         f"tensors; got strides {x.stride()} for shape {tuple(x.shape)}")
    if weight.shape != (C,) or bias.shape != (C,) or not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"weight and bias must be contiguous [{C}]")
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")
    B = x.shape[0]
    N = x.numel() // (B * C)
    S, R = chunking(N, B)
    y = torch.empty_like(x)
    ws = torch.empty(B * S * groups * 2, dtype=torch.float32, device=x.device)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdbl_groupnorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
            B, N, C, groups, S, R, float(eps), int(bool(silu)), _DTYPES[x.dtype], stream,
        )
    _build.check(err, "group_norm_silu")
    group_norm_silu.launches += 1
    return y


group_norm_silu.launches = 0
