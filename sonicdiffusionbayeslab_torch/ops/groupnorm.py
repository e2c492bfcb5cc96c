"""GroupNorm (+ optional SiLU) over channels-last activations, with the
hand-written CUDA kernel of ``csrc/groupnorm.cu``.

It replaces the JAX package's Pallas kernel ``_kernel``
(``sonicdiffusionbayeslab_tpu/ops/groupnorm.py``) and, unlike it, is the
port's default GroupNorm: every resnet norm, transformer input norm and
output norm of the UNet and VAE comes here.  The math is that of the JAX
default path (``models/layers.py::GroupNorm``): fp32 statistics, the
variance as the mean of squared deviations, output in x's dtype.

A CPU tensor takes ``plain_group_norm``; a CUDA tensor launches the kernel
or raises.  ``group_norm_silu.launches`` counts calls that launched it: one
kernel launch a call, a grid of thread-block clusters laid out by ``plan``.

Gradients: with grad mode on and an input that requires grad,
``group_norm_silu`` goes through ``GroupNormSiLUFn`` (on both devices),
whose forward is the same kernel or plain version and whose backward is
autograd through ``reference_group_norm``, the port's copy of the JAX
package's ``_gn_silu_ref`` (one-pass E[x²] − mean² statistics), as the JAX
package's ``_gn_bwd`` is ``jax.vjp`` of it.

Split across ranks (a height split over the mesh's ``seq`` axis): the
TPU kernel's grid has a pass axis, pass 0 accumulating each group's sums
and pass 1 applying them.  ``group_norm_silu_split`` does the same in two
hand-written kernels with an all-gather of the partials between them and
no other op:

* ``group_norm_partials`` (``gn_partials_kernel``): per batch item and
  group the fp32 ``(count, mean, M2)`` of this rank's rows.  It reads x
  once, so its bound is x's bytes; at a rank's 0.3-16 MB the fixed chain
  of load latency and barriers costs more.  Its own plan
  (``partials_plan``: residency asked of this kernel, one wave) cuts
  channel ranges of at least ``MIN_RANGE_BYTES`` of a row and splits a
  range's rows over several blocks where it holds more than
  ``MAX_BLOCK_BYTES``; a thread
  keeps ``ROW_LOADS`` loads in flight and shifted sums in registers, one
  shared-memory stage adds a block's lanes, and the last block of a range
  to arrive adds the blocks' sums from a small workspace in block order
  and folds channels into groups (no clusters: on the card their barrier
  cost more than the bytes).
* ``group_norm_apply`` (``gn_apply_kernel``): takes the gathered ``[S, B,
  G, 3]`` partials, merges them in its prologue in rank order with
  ``merge_group_stats``'s formula (so every rank gets the same bits), and
  applies ``(x - mean) * rstd * gamma + beta`` and the SiLU.  It reads x
  and writes y: twice the partials' bound.  ``apply_plan`` sizes its
  tiles of rows to one wave; a thread keeps its channels' constants in
  registers and ``ROW_LOADS`` loads in flight.  On request it returns the
  merged ``[B, G, 2]`` ``(mean, rstd)`` as well.

Their plain versions ``plain_group_norm_partials`` and
``plain_group_norm_apply`` (which merges with ``merge_group_stats``) run
on a CPU tensor.  Each wrapper counts its launches (``.launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from sonicdiffusionbayeslab_torch.ops import _build
from sonicdiffusionbayeslab_torch.utils import profiling

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Plan constants (NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block).
TARGET_CTAS = 128      # about one block per SM
MAX_CLUSTER = 16       # 8 is portable; the card is asked whether it holds a cluster of 16
MIN_THREADS = 128      # a block has at least this many threads where it has the rows
MAX_THREADS = 512
ROWS_PER_THREAD = 4    # rows a thread walks where the block has that many
MIN_CTA_BYTES = 8192   # a cluster of several blocks only where each reads at least this
MIN_ROW_BYTES = 64     # a channel range spans at least 64 bytes of a row where C allows
SECTOR_BYTES = 32      # ...and never less than one DRAM sector where it must go narrower
CACHE_BYTES = 96 * 1024  # a block keeps its rows in shared memory up to this size
MAX_SMEM = 232448      # 227 KB
MIN_RANGE_BYTES = 128  # the split pair's partials: a channel range reads whole 128-byte lines
ROW_LOADS = 4          # rows a thread of the split pair has in flight (kLoads in groupnorm.cu)
MAX_SPLIT = 32         # blocks the partials may split a slab's rows over...
MAX_BLOCK_BYTES = 128 * 1024   # ...where one block would read more than this,
SPLIT_BLOCK_BYTES = 64 * 1024   # ...into blocks that read at most this (measured)
PARTIAL_LANES = 32     # row lanes a partials block has at most (measured)
APPLY_CTAS = 512       # blocks the apply aims for, ~4 an SM (measured best at a seq rank's shapes)
# A range of one lane's channels keeps mean, M2, gamma and beta in shared
# memory, 16 bytes a channel: one group of 8192 channels fits 227 KB.
MAX_CHANNELS = 8192


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


def plain_group_norm_partials(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x [B, ..., C] -> [B, G, 3] fp32 ``(count, mean, M2)`` of each group
    over x's rows (M2: the sum of squared deviations from the mean)."""
    C = x.shape[-1]
    xg = x.float().reshape(x.shape[0], -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3))
    m2 = ((xg - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, xg.shape[1] * xg.shape[3]), mean, m2], dim=-1)


def merge_group_stats(parts: torch.Tensor, eps: float) -> torch.Tensor:
    """[S, B, G, 3] partials of S row slices, in row order -> [B, G, 2] fp32
    ``(mean, rstd)`` of the whole: Chan's merge of slice k into the first
    k, in that fixed order, as ``gn_cluster_kernel`` merges its blocks."""
    n, mean, m2 = parts[0].float().unbind(-1)
    for part in parts[1:]:
        nb, mb, qb = part.float().unbind(-1)
        tot = n + nb
        d = mb - mean
        mean = mean + d * (nb / tot)
        m2 = m2 + (qb + d * d * (n * nb / tot))
        n = tot
    return torch.stack([mean, torch.rsqrt(m2 / n + eps)], dim=-1)


def plain_group_norm_apply(x: torch.Tensor, parts: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float, silu: bool) -> torch.Tensor:
    """x [B, ..., C] normalised with the statistics ``merge_group_stats``
    merges from the [S, B, G, 3] partials, then the affine and optional
    SiLU in fp32; output in x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    stats = merge_group_stats(parts, eps)
    G = stats.shape[1]
    xg = x.float().reshape(B, -1, G, C // G)
    mean, rstd = (stats[..., i].float()[:, None, :, None] for i in (0, 1))
    y = ((xg - mean) * rstd).reshape(x.shape) * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut.  The grid holds ``B * ranges`` clusters of
    ``cluster`` blocks: a cluster owns one batch item and a range of
    ``range_groups`` whole groups (``channels`` channels); its block of rank
    k owns rows ``[k * rows, (k + 1) * rows)``.  A block's ``threads`` are
    ``row_lanes`` lanes of rows by ``channels / vec`` vector slots of a row
    (a thread walks several slots where there are more slots than threads).
    ``cache``: the block keeps its rows in shared memory between the
    statistics and the apply pass, so x is read once."""
    vec: int
    range_groups: int
    channels: int
    ranges: int
    cluster: int
    rows: int
    threads: int
    row_lanes: int
    cache: bool
    smem: int
    ctas: int


# The card's residency, for the model of how many clusters it holds at once.
SM_COUNT = 132
SM_THREADS = 2048
SM_REGS = 65536
SM_SMEM = 233472       # 228 KB an SM, of which each block also takes 1 KB
REGS_PER_THREAD = 64   # the kernels' __launch_bounds__(512, 2)
# Share of the card's block slots that clusters of each size fill
# (cudaOccupancyMaxActiveClusters on an H100 SXM: a cluster must fit one GPC).
CLUSTER_PACKING = {1: 1.0, 2: 1.0, 4: 0.93, 8: 0.9, 16: 0.8}


def model_active_clusters(vec: int, cluster: int, threads: int, smem: int) -> int:
    """How many clusters of ``cluster`` blocks the card holds at once,
    modelled from threads, registers and shared memory an SM."""
    per_sm = min(SM_THREADS // threads, SM_REGS // (threads * REGS_PER_THREAD),
                 SM_SMEM // (smem + 1024), 32)
    return int(SM_COUNT * per_sm / cluster * CLUSTER_PACKING[cluster])


@functools.lru_cache(maxsize=None)
def card_active_clusters(dtype: int, vec: int, cluster: int, threads: int, smem: int) -> int:
    """The card's own answer (cudaOccupancyMaxActiveClusters) for the kernel
    instantiation of ``dtype`` (0 float32, 1 bfloat16) and ``vec``."""
    out = ctypes.c_int(0)
    _build.check(_build.kernels().sdbl_groupnorm_active_clusters(dtype, vec, cluster, threads,
                                                                 smem, ctypes.byref(out)),
                 "cudaOccupancyMaxActiveClusters")
    return out.value


@functools.lru_cache(maxsize=None)
def card_active_blocks(dtype: int, vec: int, threads: int, smem: int) -> int:
    """The card's own answer (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    times its SMs) for ``gn_partials_kernel``'s instantiation of ``dtype``
    and ``vec``."""
    out = ctypes.c_int(0)
    _build.check(_build.kernels().sdbl_groupnorm_partials_active_blocks(
        dtype, vec, threads, smem, ctypes.byref(out)),
        "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return out.value


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def _smem(row_lanes: int, channels: int, range_groups: int, rows: int, elem: int,
          cache: bool) -> int:
    """Bytes of dynamic shared memory, laid out as in ``groupnorm.cu``: the
    cached rows (16-byte aligned), the per-lane (mean, M2) scratch, gamma
    and beta, the block's per-group partials and the merged statistics."""
    cached = -(-rows * channels * elem // 16) * 16 if cache else 0
    return cached + 4 * (2 * row_lanes * channels + 2 * channels + 4 * range_groups)


def _layout(B: int, N: int, C: int, G: int, elem: int, vec: int, range_groups: int,
            cluster: int) -> Plan:
    gs = C // G
    channels = range_groups * gs
    slots = channels // vec
    rows = -(-N // cluster)
    lanes = max(_pow2_ceil(-(-rows // ROWS_PER_THREAD)),
                min(_pow2_ceil(-(-MIN_THREADS // slots)), _pow2_ceil(rows)))
    lanes = min(lanes, _pow2_floor(max(1, MAX_THREADS // slots)))
    threads = -(-min(MAX_THREADS, lanes * slots) // 32) * 32
    cache = rows * channels * elem <= CACHE_BYTES
    ranges = G // range_groups
    return Plan(vec=vec, range_groups=range_groups, channels=channels, ranges=ranges,
                cluster=cluster, rows=rows, threads=threads, row_lanes=lanes, cache=cache,
                smem=_smem(lanes, channels, range_groups, rows, elem, cache),
                ctas=B * ranges * cluster)


def _vector(C: int, G: int, elem: int, aligned: bool) -> int:
    """16 bytes' worth of elements where C and whole groups allow it and x
    is 16-byte aligned, else 1."""
    vec = 16 // elem
    if not aligned or C % vec or G % (vec // math.gcd(C // G, vec)):
        return 1
    return vec


def plan(B: int, N: int, C: int, G: int, elem: int, aligned: bool = True,
         active_clusters=model_active_clusters) -> Plan:
    """The launch plan for x ``[B, N, C]`` with ``G`` groups and elements of
    ``elem`` bytes.

    16-byte vectors (8 bf16 or 4 fp32) wherever C and whole groups allow
    it and x is 16-byte aligned, else one element at a time.  A channel
    range holds whole groups, a multiple of the vector, and at least
    ``MIN_ROW_BYTES`` of a row where C has that many.  Among cluster sizes
    1, 2, 4, 8 (smallest first) and ranges (widest first) it takes the
    first layout with ``TARGET_CTAS`` blocks; where none has that many,
    the one with the most.  Only layouts whose clusters the card holds all
    at once count (``active_clusters(vec, cluster, threads, smem)``; a
    second wave would double the time), and a cluster of several blocks
    only where each block reads at least ``MIN_CTA_BYTES``.  A shape with
    the work to fill the card (``TARGET_CTAS`` blocks of ``MIN_CTA_BYTES``)
    that no such layout fills, e.g. one image at 128 channels, takes
    ranges narrower than ``MIN_ROW_BYTES`` too, down to ``SECTOR_BYTES``.  Where no layout fits one
    wave, the first that fits shared memory."""
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    gs = C // G
    vec = _vector(C, G, elem, aligned)
    g0 = vec // math.gcd(gs, vec)
    widths = [k for k in range(g0, G + 1, g0) if G % k == 0]
    wide = [k for k in widths if k * gs * elem >= MIN_ROW_BYTES]
    narrow = [k for k in widths if k not in wide and k * gs * elem >= SECTOR_BYTES][::-1]
    passes = [(wide or widths[-1:])[::-1]]
    if wide and narrow and B * N * C * elem >= TARGET_CTAS * MIN_CTA_BYTES:
        passes.append(narrow)
    best = fallback = None
    for widths in passes:
        for cluster in (1, 2, 4, 8, 16):
            if cluster > MAX_CLUSTER or (cluster - 1) * -(-N // cluster) >= N:
                continue  # every block of a cluster owns at least one row
            for k in widths:
                p = _layout(B, N, C, G, elem, vec, k, cluster)
                if p.smem > MAX_SMEM:
                    continue
                fallback = fallback or p
                if cluster > 1 and p.rows * p.channels * elem < MIN_CTA_BYTES:
                    continue
                if B * p.ranges > active_clusters(vec, cluster, p.threads, p.smem):
                    continue
                if p.ctas >= TARGET_CTAS:
                    return p
                if best is None or p.ctas > best.ctas:
                    best = p
    if fallback is None:
        raise ValueError(f"no GroupNorm plan fits {MAX_SMEM} bytes of shared memory for "
                         f"C={C}, G={G}")
    return best or fallback


def partials_smem(row_lanes: int, channels: int) -> int:
    """``gn_partials_kernel``'s dynamic shared memory: each item's two sums
    a channel ([lanes][channels] twice) and the block's ([2][channels])."""
    return 4 * (2 * row_lanes * channels + 2 * channels)


@dataclasses.dataclass(frozen=True)
class PartialsPlan:
    """How ``gn_partials_kernel`` cuts one call.  The grid holds ``B *
    ranges * split`` blocks: a batch item's range of ``range_groups``
    whole groups (``channels`` channels) is a slab, whose rows its
    ``split`` blocks share, ``rows`` a block.  A block's ``threads`` are
    ``row_lanes`` lanes of rows by ``channels / vec`` vector slots."""
    vec: int
    range_groups: int
    channels: int
    ranges: int
    split: int
    rows: int
    threads: int
    row_lanes: int
    smem: int
    ctas: int


def model_active_blocks(vec: int, threads: int, smem: int) -> int:
    """How many blocks of ``threads`` threads and ``smem`` bytes of shared
    memory the card holds at once, modelled from threads, registers and
    shared memory an SM."""
    return model_active_clusters(vec, 1, threads, smem)


def _partials_layout(B: int, N: int, C: int, G: int, vec: int, range_groups: int,
                     split: int) -> PartialsPlan:
    channels = range_groups * (C // G)
    slots = channels // vec
    rows = -(-N // split)
    lanes = max(min(-(-rows // ROW_LOADS), 8), min(-(-rows // (2 * ROW_LOADS)), PARTIAL_LANES))
    lanes = max(1, min(lanes, MAX_THREADS // slots))
    threads = -(-min(MAX_THREADS, lanes * slots) // 32) * 32
    ranges = G // range_groups
    return PartialsPlan(vec=vec, range_groups=range_groups, channels=channels, ranges=ranges,
                        split=split, rows=rows, threads=threads, row_lanes=lanes,
                        smem=partials_smem(lanes, channels), ctas=B * ranges * split)


def partials_plan(B: int, N: int, C: int, G: int, elem: int, aligned: bool = True,
                  active_blocks=model_active_blocks) -> PartialsPlan:
    """``gn_partials_kernel``'s launch plan for x ``[B, N, C]`` in ``G``
    groups.

    A channel range holds whole groups, a multiple of the vector, and at
    least ``MIN_RANGE_BYTES`` of a row where C has that many (the
    narrowest such range; else the widest).  A slab (a batch item's range)
    of more than ``MAX_BLOCK_BYTES`` has its rows split over the fewest
    blocks (2, 4, ..., ``MAX_SPLIT``) that leave each at most
    ``SPLIT_BLOCK_BYTES``; a smaller slab is one block.  On the card a
    split (a merge through device memory) cost more than a block reading
    up to 128 KB, while a split slab gained from finer blocks.  A
    block has a row lane for each two rounds of ``ROW_LOADS`` rows (one
    round where that leaves fewer than 8 lanes), at most
    ``PARTIAL_LANES`` lanes and ``MAX_THREADS`` threads.  The split backs
    off where the grid would not fit one wave (``active_blocks(vec,
    threads, smem)`` of this kernel)."""
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    gs = C // G
    vec = _vector(C, G, elem, aligned)
    g0 = vec // math.gcd(gs, vec)
    widths = [k for k in range(g0, G + 1, g0) if G % k == 0]
    k = next((k for k in widths if k * gs * elem >= MIN_RANGE_BYTES), widths[-1])
    split, limit = 1, MAX_BLOCK_BYTES
    while (split < MAX_SPLIT and -(-N // split) * k * gs * elem > limit
           and split * -(-N // (2 * split)) < N):  # every block keeps a row
        split, limit = 2 * split, SPLIT_BLOCK_BYTES
    p = _partials_layout(B, N, C, G, vec, k, split)
    while p.split > 1 and p.ctas > active_blocks(vec, p.threads, p.smem):
        p = _partials_layout(B, N, C, G, vec, k, p.split // 2)
    if p.smem > MAX_SMEM:
        raise ValueError(f"no split GroupNorm plan fits {MAX_SMEM} bytes of shared memory for "
                         f"C={C}, G={G}")
    return p


@dataclasses.dataclass(frozen=True)
class ApplyPlan:
    """``gn_apply_kernel``'s grid: ``tiles`` tiles of ``tile_rows`` rows a
    batch item, a block a tile, of ``threads`` threads as ``row_lanes``
    lanes of rows by ``C / vec`` vector slots (a thread takes several
    (lane, slot) items where there are more than threads)."""
    vec: int
    threads: int
    row_lanes: int
    tile_rows: int
    tiles: int
    ctas: int


def apply_wave(threads: int) -> int:
    """Blocks of ``threads`` threads (no shared memory) the card holds at
    once, modelled from threads and registers an SM."""
    return SM_COUNT * min(SM_THREADS // threads, SM_REGS // (threads * REGS_PER_THREAD), 32)


def apply_plan(B: int, N: int, C: int, elem: int, aligned: bool = True) -> ApplyPlan:
    """``gn_apply_kernel``'s grid for x ``[B, N, C]``: 16-byte vectors where
    C and the alignment of x and y allow; the fewest row lanes that give a
    block two warps of slots; then rows a lane doubled from 1 up to
    ``2 * ROW_LOADS`` while the grid has more than ``APPLY_CTAS`` blocks,
    and raised further only where it would not fit one wave
    (``apply_wave``)."""
    vec = 16 // elem
    if not aligned or C % vec:
        vec = 1
    slots = C // vec
    lanes = max(1, min(-(-64 // slots), N))
    threads = -(-min(MAX_THREADS, lanes * slots) // 32) * 32
    per_lane = 1
    while per_lane < 2 * ROW_LOADS and B * -(-N // (lanes * per_lane)) > APPLY_CTAS:
        per_lane *= 2
    while per_lane * lanes < N and B * -(-N // (lanes * per_lane)) > apply_wave(threads):
        per_lane += 1
    tile_rows = lanes * per_lane
    tiles = -(-N // tile_rows)
    return ApplyPlan(vec=vec, threads=threads, row_lanes=lanes, tile_rows=tile_rows, tiles=tiles,
                     ctas=B * tiles)


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) with fp32 one-pass statistics (variance as
    E[x²] − mean²): the function whose gradient ``GroupNormSiLUFn``
    takes, as the JAX package's ``_gn_silu_ref``."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class GroupNormSiLUFn(torch.autograd.Function):
    """``group_norm_silu``'s kernel (CUDA) or plain version (CPU) forward,
    with the gradient of ``reference_group_norm`` as its backward; saves
    x, weight and bias.  ``groups`` is already resolved."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (groups, eps, silu)
        return _group_norm_silu(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), profiling.span("group_norm.backward"):
            y = reference_group_norm(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """x [B, H, W, C] or [B, N, C] (channels last) -> GroupNorm(+SiLU).

    ``groups`` follows the gcd rule when C does not divide by it.  With grad
    mode on and an input that requires grad the call goes through
    ``GroupNormSiLUFn``."""
    groups = resolve_groups(x.shape[-1], groups)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormSiLUFn.apply(x, weight, bias, groups, eps, silu)
    return _group_norm_silu(x, weight, bias, groups, eps, silu)


def _group_norm_silu(x, weight, bias, groups, eps, silu):
    """The kernel on a CUDA tensor, ``plain_group_norm`` on a CPU one."""
    C = x.shape[-1]
    # Statistics and normalisation ~6 operations an element, SiLU ~4 more;
    # counted on both paths (FlopCounterMode counts no elementwise work).
    _build.add_flops((10 if silu else 6) * x.numel())
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
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        p = card_plan(B, N, C, groups, _DTYPES[x.dtype], x.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernels().sdbl_groupnorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, N, C, groups, p.vec, p.range_groups, p.cluster, p.threads, p.row_lanes,
            int(p.cache), float(eps), int(bool(silu)), _DTYPES[x.dtype], stream,
        )
    _build.check(err, "group_norm_silu")
    _build.count_launch(group_norm_silu)
    return y


group_norm_silu.launches = 0


def _check_kernel_inputs(x: torch.Tensor, what: str, *params: torch.Tensor) -> None:
    """The kernels' device, dtype, shape and stride rules."""
    C = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPES or any(p.dtype != x.dtype for p in params):
        raise TypeError(f"{what} takes float32 or bfloat16 x, weight and bias of one dtype, "
                        f"got {[t.dtype for t in (x, *params)]}")
    if x.dim() < 3:
        raise ValueError(f"expected [B, ..., C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}'s kernel reads contiguous channels-last [B, ..., C] tensors; "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    if any(p.shape != (C,) or not p.is_contiguous() or p.device != x.device for p in params):
        raise ValueError(f"weight and bias must be contiguous [{C}] on {x.device}")
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")


def group_norm_partials(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x [B, ..., C] -> [B, G, 3] fp32 ``(count, mean, M2)`` of each of the
    ``groups`` groups over x's rows: ``gn_partials_kernel`` on a CUDA
    tensor (laid out by ``card_partials_plan``),
    ``plain_group_norm_partials`` on a CPU one."""
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"channels {C} not divisible by groups {groups}")
    _build.add_flops(4 * x.numel())
    if x.device.type == "cpu":
        return plain_group_norm_partials(x, groups)
    _check_kernel_inputs(x, "group_norm_partials")
    B = x.shape[0]
    N = x.numel() // (B * C)
    stats = torch.empty(B, groups, 3, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        p = card_partials_plan(B, N, C, groups, _DTYPES[x.dtype], x.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream().cuda_stream
        work = arrivals = None
        if p.split > 1:
            work = torch.empty(2 * p.split * B * C, dtype=torch.float32, device=x.device)
            arrivals = _arrivals(x.device, stream, B * p.ranges)
        err = _build.kernels().sdbl_groupnorm_partials(
            x.data_ptr(), stats.data_ptr(), None if work is None else work.data_ptr(),
            None if arrivals is None else arrivals.data_ptr(), B, N, C, groups, p.vec,
            p.range_groups, p.split, p.threads, p.row_lanes, _DTYPES[x.dtype], stream)
    _build.check(err, "group_norm_partials")
    _build.count_launch(group_norm_partials)
    return stats


group_norm_partials.launches = 0
# Per device and stream, the partials kernel's arrival counters: zeroed
# once, and every launch leaves them at 0 (its last block of a slab resets
# its counter), so eager calls and graph replays share them.
_ARRIVALS: dict = {}


def _arrivals(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the partials kernel on
    ``stream``."""
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def group_norm_apply(x: torch.Tensor, parts: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = True, *,
                     return_stats: bool = False):
    """x [B, ..., C] normalised with the statistics merged from the [S, B,
    G, 3] fp32 partials ``(count, mean, M2)`` of S row slices (in row
    order, as ``merge_group_stats`` merges them) -> ``(x - mean) * rstd *
    weight + bias`` (+ SiLU) in x's dtype: ``gn_apply_kernel`` on a CUDA
    tensor, ``plain_group_norm_apply`` on a CPU one.  With
    ``return_stats``, ``(y, [B, G, 2] fp32 (mean, rstd))``: on a CUDA
    tensor the statistics the kernel merged."""
    B, C = x.shape[0], x.shape[-1]
    if (parts.dim() != 4 or parts.shape[0] < 1 or parts.shape[1] != B or parts.shape[3] != 3
            or C % parts.shape[2]):
        raise ValueError(f"parts {tuple(parts.shape)} is not [S, {B}, G, 3] with G dividing {C}")
    G = parts.shape[2]
    _build.add_flops((6 if silu else 2) * x.numel())
    if x.device.type == "cpu":
        y = plain_group_norm_apply(x, parts, weight, bias, eps, silu)
        return (y, merge_group_stats(parts, eps)) if return_stats else y
    _check_kernel_inputs(x, "group_norm_apply", weight, bias)
    if (parts.dtype != torch.float32 or parts.device != x.device
            or not parts.is_contiguous()):
        raise ValueError("parts must be contiguous float32 on x's device")
    N = x.numel() // (B * C)
    y = torch.empty_like(x)
    stats = (torch.empty(B, G, 2, dtype=torch.float32, device=x.device) if return_stats
             else None)
    p = apply_plan(B, N, C, x.element_size(), x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = _build.kernels().sdbl_groupnorm_apply(
            x.data_ptr(), parts.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if stats is None else stats.data_ptr(), parts.shape[0], B, N, C, G, p.vec,
            p.threads, p.row_lanes, p.tile_rows, float(eps), int(bool(silu)), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_apply")
    _build.count_launch(group_norm_apply)
    return (y, stats) if return_stats else y


group_norm_apply.launches = 0


def group_norm_silu_split(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          groups: int, eps: float, silu: bool, group) -> torch.Tensor:
    """GroupNorm(+SiLU) of a map whose rows are split over the ranks of
    ``group`` (this rank's rows in ``x``): the partials of the local rows,
    gathered in rank order, merged and applied by one kernel.  Inference
    only: the JAX package trains under ``data`` and ``model``, never
    ``seq``."""
    from sonicdiffusionbayeslab_torch.parallel import distributed

    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError("GroupNorm across a seq split has no gradient: training under "
                                  "seq is not a JAX package feature")
    groups = resolve_groups(x.shape[-1], groups)
    parts = distributed.all_gather_seq(group_norm_partials(x, groups)[None], 0, group)
    return group_norm_apply(x, parts, weight, bias, eps, silu)


@functools.lru_cache(maxsize=None)
def card_plan(B: int, N: int, C: int, G: int, dtype: int, aligned: bool) -> Plan:
    """``plan`` with the card's own occupancy answers for the fused kernel;
    ``dtype`` 0 float32, 1 bfloat16."""
    return plan(B, N, C, G, 4 if dtype == 0 else 2, aligned,
                functools.partial(card_active_clusters, dtype))


@functools.lru_cache(maxsize=None)
def card_partials_plan(B: int, N: int, C: int, G: int, dtype: int,
                       aligned: bool) -> PartialsPlan:
    """``partials_plan`` with the card's own occupancy answers for the
    partials kernel; ``dtype`` 0 float32, 1 bfloat16."""
    return partials_plan(B, N, C, G, 4 if dtype == 0 else 2, aligned,
                         functools.partial(card_active_blocks, dtype))
