"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU, and never a quiet fall back to the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when CUDA is asked for (or implied)
    and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block
    (restored after): the metric towers compute their features in fp32, as
    the JAX reference does, while the bf16 pipeline keeps torch's defaults."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
