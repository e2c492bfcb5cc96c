"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W power
limit) and the least time of a kernel's work at a shape: each input byte
read once and each output byte written once at the HBM rate, or the
operations at their peak rate, whichever takes longer.  The arithmetic is
``chip_smoke.py::bound``'s, kept here so that the yardstick does not move
with the program.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_EXP = 3.9e12  # exponentials a second on the special-function units
PEAK_BYTES = 3.35e12  # bytes a second, HBM3


def attention_bound_s(B: int, N: int, M: int, H: int, D: int, itemsize: int = 2) -> float:
    """Least seconds of softmax(q k^T) v at [B, N|M, H, D]: its two products
    on the bf16 tensor cores or its B*H*N*M exponentials, against reading
    q, k and v and writing o once."""
    ops = max(4.0 * B * H * N * M * D / PEAK_BF16, B * H * N * M / PEAK_EXP)
    nbytes = (2 * B * N * H * D + 2 * B * M * H * D) * itemsize
    return max(ops, nbytes / PEAK_BYTES)


def group_norm_bound_s(B: int, N: int, C: int, silu: bool, itemsize: int = 2) -> float:
    """Least seconds of GroupNorm(+SiLU) of [B, N, C]: ~10 fp32 operations
    an element with SiLU (6 without), against reading x and writing y once
    (and the C-wide scale and shift)."""
    ops = (10 if silu else 6) * B * N * C / PEAK_FP32
    nbytes = (2 * B * N * C + 2 * C) * itemsize
    return max(ops, nbytes / PEAK_BYTES)
