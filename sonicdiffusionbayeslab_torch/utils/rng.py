"""Deterministic per-sample noise for the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/utils/rng.py``: sample ``i``'s
initial latents depend only on (seed, i), never on the batch it rides in.
Each sample gets its own CPU ``torch.Generator``, seeded from a numpy
``SeedSequence`` of (seed, i); the latents are drawn on the CPU and then
moved, so one seed gives the same latents on every device.  The bits differ
from the JAX package's, so parity tests pass ``init_latents``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def sample_generator(seed: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def per_sample_latents(seed: int, sample_indices: Sequence[int], shape, device="cpu",
                       dtype=torch.float32) -> torch.Tensor:
    """[B, *shape] standard normal latents, row b drawn from sample
    ``sample_indices[b]``'s own generator."""
    rows = [torch.randn(tuple(shape), generator=sample_generator(seed, i), dtype=torch.float32)
            for i in sample_indices]
    return torch.stack(rows).to(device=device, dtype=dtype)
