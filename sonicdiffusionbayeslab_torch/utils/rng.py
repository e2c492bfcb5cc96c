"""Deterministic per-sample noise for the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/utils/rng.py``: sample ``i``'s
initial latents depend only on (seed, i), never on the batch it rides in.
Each sample gets its own CPU ``torch.Generator``, seeded from a numpy
``SeedSequence`` of (seed, i); the latents are drawn on the CPU and then
moved, so one seed gives the same latents on every device.  The bits differ
from the JAX package's, so parity tests pass ``init_latents``.

Noise-injecting plans (LCM) draw fresh noise at each denoising step the
same way: sample ``i``'s noise at step ``k`` depends only on (seed, i, k).

img2img's draws (the encoder's posterior sample, the start noise and
inpainting's blend noise) are sample ``i``'s from (seed, i, tag), a tag
each.

Token Merging's random destinations (one per cell of each ToMe slot's
token map) depend only on (timestep, site, block), with no seed, as the JAX
package's ``fold_in`` chain from ``PRNGKey(0x703E)`` does; the draws are
the port's own, so parity tests pass the JAX package's destinations.

An experiment's grid point ``g`` draws from ``grid_seed(seed, g)`` where
the JAX package folds ``g`` into its key: latents then depend only on
(seed, grid point, sample index), as there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.ops.tome import dst_index_grid

# Separates the step-noise streams from the initial latents' streams.
STEP_NOISE_TAG = 0x5EED
# The stream of Token Merging's destinations.
TOME_TAG = 0x703E
# The streams of inpainting's blend noise (the JAX engine's fold-in tag),
# img2img's posterior sample of the encoder and its start noise.
BLEND_NOISE_TAG = 0xB1E0D
ENCODE_NOISE_TAG = 0xE1C0D
INIT_NOISE_TAG = 0x1217


def sample_generator(seed: int, index: int, *stream: int) -> torch.Generator:
    entropy = [int(seed), int(index), *map(int, stream)]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def per_sample_latents(seed: int, sample_indices: Sequence[int], shape, device="cpu",
                       dtype=torch.float32) -> torch.Tensor:
    """[B, *shape] standard normal latents, row b drawn from sample
    ``sample_indices[b]``'s own generator."""
    rows = [torch.randn(tuple(shape), generator=sample_generator(seed, i), dtype=torch.float32)
            for i in sample_indices]
    return torch.stack(rows).to(device=device, dtype=dtype)


def per_sample_noise(seed: int, sample_indices: Sequence[int], shape, *stream: int,
                     device="cpu") -> torch.Tensor:
    """[B, *shape] fp32 standard normal noise, row b drawn from the
    generator of (seed, ``sample_indices[b]``, *stream)."""
    rows = [torch.randn(tuple(shape), generator=sample_generator(seed, i, *stream),
                        dtype=torch.float32) for i in sample_indices]
    return torch.stack(rows).to(device=device)


def per_sample_step_noise(seed: int, sample_indices: Sequence[int], step: int, shape,
                          device="cpu") -> torch.Tensor:
    """[B, *shape] fp32 standard normal noise of denoising step ``step``,
    row b drawn from the generator of (seed, ``sample_indices[b]``, step)."""
    return per_sample_noise(seed, sample_indices, shape, STEP_NOISE_TAG, step, device=device)


def tome_destinations(timestep: int, slots, tome) -> torch.Tensor:
    """[len(slots), D] int64 on the CPU: row k holds ToMe slot k's
    destinations (``slots`` from ``UNet2DCondition.tome_slots``: site,
    block and token map of each), drawn from the generator of (timestep,
    site, block), zero-padded to the widest map's D."""
    rows = [dst_index_grid(h, w, tome.sy, tome.sx, sample_generator(
        TOME_TAG, int(timestep), site, block)) for site, block, h, w in slots]
    out = torch.zeros((len(rows), max((len(r) for r in rows), default=0)), dtype=torch.int64)
    for k, r in enumerate(rows):
        out[k, :len(r)] = r
    return out


def grid_seed(seed: int, grid_index: int) -> int:
    """The pipeline seed of one sweep grid point (the JAX package's
    ``grid_key``): an int derived from (seed, grid_index)."""
    state = np.random.SeedSequence([int(seed), int(grid_index)]).generate_state(1, np.uint64)[0]
    return int(state) & 0x7FFF_FFFF_FFFF_FFFF


def setup_seed(seed: int) -> int:
    """Seed numpy's and torch's global generators (the JAX package's
    ``setup_seed``); returns the experiment seed."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)
