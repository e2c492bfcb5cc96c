"""The split GroupNorm pair (``group_norm_partials``, ``group_norm_apply``)
on the CPU: the two kernels' launch plans at a seq rank's shapes, Python
emulations of their arithmetic and merge order against the plain
versions, the plain pair against ``plain_group_norm``, and the emulated
pair on row slices against the JAX package's Pallas kernel (interpret
mode, several row blocks on its pass axis).  The CUDA kernels against
their plain versions are in ``test_torch_kernels.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, t
from sonicdiffusionbayeslab_torch.ops import groupnorm as gn_ops
from sonicdiffusionbayeslab_torch.utils.trace_analysis import SPLIT_SYMBOLS, SYMBOLS
from sonicdiffusionbayeslab_tpu.ops.groupnorm import group_norm_silu as pallas_group_norm

# The SD-1.5 UNet's GroupNorm maps at 512x512 (rows N, channels C, groups
# G) at batch 4 (2 under CFG): every level's norms, plus norm2 on C/2 in
# G/2 groups as a rank of a seq x model mesh runs it.  A seq rank holds
# N / n of the rows, n = 2 or 4.
UNET_MAPS = [(4096, 320, 32), (4096, 640, 32), (4096, 960, 32), (1024, 320, 32),
             (1024, 640, 32), (1024, 960, 32), (1024, 1280, 32), (1024, 1920, 32),
             (256, 640, 32), (256, 1280, 32), (256, 1920, 32), (256, 2560, 32), (64, 1280, 32),
             (64, 2560, 32), (4096, 160, 16), (1024, 320, 16), (256, 640, 16), (64, 640, 16)]
RANK_SHAPES = [(4, N // n, C, G) for N, C, G in UNET_MAPS for n in (2, 4)]


def partials_reads(p, B, N, C):
    """How often ``gn_partials_kernel`` under plan ``p`` reads each 16-byte
    vector (or element) of x [B, N, C]: slabs (b, range), blocks k of
    ``p.rows`` rows, items (lane, slot) taken by threads e, e + threads,
    ..., rows lane, lane + lanes, ... ``ROW_LOADS`` at a time."""
    count = np.zeros((B, N, C // p.vec), np.int64)
    slots = p.channels // p.vec
    lane = np.arange(p.row_lanes * slots) // slots
    col = (np.arange(p.row_lanes * slots) % slots)[:, None] + slots * np.arange(p.ranges)
    for k in range(p.split):
        rows = max(0, min(p.rows, N - k * p.rows))
        assert rows > 0  # every block of a slab owns a row
        for m in range(-(-rows // p.row_lanes)):
            r = lane + m * p.row_lanes
            keep = r < rows
            np.add.at(count, (slice(None), (k * p.rows + r[keep])[:, None], col[keep]), 1)
    return count


def apply_reads(a, B, N, C):
    """How often ``gn_apply_kernel`` under ``a`` reads (and writes) each
    vector of x [B, N, C]: blocks (tile, b), items (lane, slot), rows
    lane, lane + lanes, ... of the tile."""
    count = np.zeros((B, N, C // a.vec), np.int64)
    slots = C // a.vec
    lane = np.arange(a.row_lanes * slots) // slots
    slot = np.arange(a.row_lanes * slots) % slots
    for tile in range(a.tiles):
        rows = min(a.tile_rows, N - tile * a.tile_rows)
        assert rows > 0
        for m in range(-(-a.tile_rows // a.row_lanes)):
            r = lane + m * a.row_lanes
            keep = r < rows
            np.add.at(count, (slice(None), tile * a.tile_rows + r[keep], slot[keep]), 1)
    return count


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,N,C,G", RANK_SHAPES)
def test_split_plans_fit_one_wave_and_cover_every_vector_once(B, N, C, G, elem):
    p = gn_ops.partials_plan(B, N, C, G, elem)
    assert p.vec == 16 // elem
    assert p.channels == p.range_groups * (C // G) and p.ranges * p.channels == C
    assert p.channels * elem >= gn_ops.MIN_RANGE_BYTES  # a warp reads whole 128-byte lines
    assert 1 <= p.split <= gn_ops.MAX_SPLIT and p.ctas == B * p.ranges * p.split
    assert p.threads % 32 == 0 and 32 <= p.threads <= gn_ops.MAX_THREADS
    slots = p.channels // p.vec  # a thread an item, or one lane of items a thread walks
    assert p.row_lanes * slots <= p.threads or p.row_lanes == 1
    loads = gn_ops.ROW_LOADS  # two rounds of loads a lane (one where that leaves < 8 lanes)
    lanes = max(min(-(-p.rows // loads), 8), min(-(-p.rows // (2 * loads)), gn_ops.PARTIAL_LANES))
    assert p.row_lanes == max(1, min(lanes, gn_ops.MAX_THREADS // slots))
    assert p.smem == gn_ops.partials_smem(p.row_lanes, p.channels) <= gn_ops.MAX_SMEM
    assert gn_ops.MAX_SMEM <= 227 * 1024
    assert p.ctas <= gn_ops.model_active_blocks(p.vec, p.threads, p.smem)  # one wave
    # Rows split only where one block would read more than MAX_BLOCK_BYTES,
    # and then over the fewest blocks that read at most SPLIT_BLOCK_BYTES.
    block_bytes = p.rows * p.channels * elem
    if p.split == 1:
        assert block_bytes <= gn_ops.MAX_BLOCK_BYTES
    else:
        assert N * p.channels * elem > gn_ops.MAX_BLOCK_BYTES
        finer = 2 * p.ctas <= gn_ops.model_active_blocks(p.vec, p.threads, p.smem)
        assert block_bytes <= gn_ops.SPLIT_BLOCK_BYTES or not finer  # backed off to one wave
        assert gn_ops.SPLIT_BLOCK_BYTES < 2 * block_bytes or p.split == 2
    assert (partials_reads(p, B, N, C) == 1).all()

    a = gn_ops.apply_plan(B, N, C, elem)
    assert a.vec == 16 // elem
    assert a.threads % 32 == 0 and 32 <= a.threads <= gn_ops.MAX_THREADS
    assert a.row_lanes * (C // a.vec) <= a.threads or a.row_lanes == 1
    assert a.tile_rows % a.row_lanes == 0 and a.tiles == -(-N // a.tile_rows)
    assert a.ctas == B * a.tiles <= gn_ops.apply_wave(a.threads)  # one wave
    if B * N >= gn_ops.SM_COUNT:
        assert a.ctas >= gn_ops.SM_COUNT  # every SM has a block where there are the rows
    assert (apply_reads(a, B, N, C) == 1).all()


@pytest.mark.parametrize("C,G", [(20, 4), (48, 16), (640, 32), (gn_ops.MAX_CHANNELS, 1),
                                 (gn_ops.MAX_CHANNELS - 1, 1)])
@pytest.mark.parametrize("N", [1, 7, 300])
def test_split_plans_fit_odd_shapes(C, G, N):
    """Narrow, unaligned and single-group shapes: a plan exists, fits
    shared memory, and covers every vector once."""
    for elem in (2, 4):
        for aligned in (True, False):
            p = gn_ops.partials_plan(2, N, C, G, elem, aligned)
            assert p.smem <= gn_ops.MAX_SMEM and p.threads <= gn_ops.MAX_THREADS
            assert p.vec == 1 or (aligned and C % p.vec == 0)
            if N * C <= 300 * 640:
                assert (partials_reads(p, 2, N, C) == 1).all()
            a = gn_ops.apply_plan(2, N, C, elem, aligned)
            assert a.ctas <= gn_ops.apply_wave(a.threads)
            if N * C <= 300 * 640:
                assert (apply_reads(a, 2, N, C) == 1).all()


def emulate_partials(x, G, p):
    """``gn_partials_kernel``'s arithmetic in float32: each item's sums of d
    = x - shift (the channel's value in row 0) and d * d over its rows, the
    block's lanes added in order, the slab's blocks in block order, then a
    mean and M2 a channel folded into groups.  [B, G, 3]."""
    B, N, C = x.shape
    gs = C // G
    out = torch.empty(B, G, 3)
    for b in range(B):
        for rng in range(p.ranges):
            cols = slice(rng * p.channels, (rng + 1) * p.channels)
            shift = x[b, 0, cols]
            t1 = torch.zeros(p.channels)
            t2 = torch.zeros(p.channels)
            for k in range(p.split):  # block order
                d = x[b, k * p.rows:min(N, (k + 1) * p.rows), cols] - shift
                b1 = torch.zeros(p.channels)
                b2 = torch.zeros(p.channels)
                for lane in range(p.row_lanes):  # the block's lanes in order
                    b1 = b1 + d[lane::p.row_lanes].sum(0)
                    b2 = b2 + (d[lane::p.row_lanes] ** 2).sum(0)
                t1, t2 = t1 + b1, t2 + b2
            m = t1 / N
            mean_c = shift + m
            m2_c = torch.clamp(t2 - t1 * m, min=0.0)
            cm = mean_c.reshape(p.range_groups, gs)
            mu = cm.sum(1) / gs
            q = (m2_c.reshape(p.range_groups, gs) + N * (cm - mu[:, None]) ** 2).sum(1)
            g = slice(rng * p.range_groups, (rng + 1) * p.range_groups)
            out[b, g, 0] = float(N * gs)
            out[b, g, 1] = mu
            out[b, g, 2] = q
    return out


@pytest.mark.parametrize("offset", [1.0, 1000.0])
@pytest.mark.parametrize("B,N,C,G", [(2, 64, 64, 32), (2, 300, 64, 32), (1, 512, 320, 32),
                                     (2, 37, 20, 4), (4, 32, 1280, 32)])
def test_partials_emulation_matches_plain(B, N, C, G, offset):
    """The kernel's shifted sums and merge order give the plain two-pass
    partials within 1e-6 relative (mean) and 1e-5 relative (M2), also
    where every channel sits ~300 of its standard deviations from zero:
    the shift keeps the sums small."""
    x = t(randn((B, N, C), 11, 3.0)) * torch.linspace(0.5, 2.0, C) + offset
    p = gn_ops.partials_plan(B, N, C, G, 4)
    got = emulate_partials(x, G, p)
    want = gn_ops.plain_group_norm_partials(x, G)
    assert torch.equal(got[..., 0], want[..., 0])
    torch.testing.assert_close(got[..., 1], want[..., 1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[..., 2], want[..., 2], atol=0.0, rtol=1e-5)


def emulate_apply_constants(parts, C, vec, eps):
    """``gn_apply_kernel``'s prologue: a table of each batch item's groups,
    each merged from the [S, B, G, 3] partials in rank order with
    ``merge_parts``' operations on float32 scalars; then each vector slot
    reads its channels' groups from it, tracking group boundaries as the
    kernel does.  Returns (mean, rstd) a channel, [B, C] each."""
    S, B, G, _ = parts.shape
    gs = C // G
    p = parts.numpy().astype(np.float32)
    f32 = np.float32

    def merge(b, g):
        n, mean, m2 = p[0, b, g]
        for s in range(1, S):
            nb, mb, qb = p[s, b, g]
            tot = f32(n + nb)
            d = f32(mb - mean)
            mean = f32(mean + f32(d * f32(nb / tot)))
            m2 = f32(m2 + f32(qb + f32(f32(d * d) * f32(f32(n * nb) / tot))))
            n = tot
        return mean, f32(1) / np.sqrt(f32(f32(m2 / n) + f32(eps)))

    mu = np.empty((B, C), np.float32)
    rs = np.empty((B, C), np.float32)
    for b in range(B):
        table = [merge(b, g) for g in range(G)]
        for slot in range(C // vec):
            c0 = slot * vec
            g = c0 // gs
            end = (g + 1) * gs
            for j in range(vec):
                if c0 + j >= end:  # the vector crosses into the next group
                    g, end = g + 1, end + gs
                mu[b, c0 + j], rs[b, c0 + j] = table[g]
    return torch.from_numpy(mu), torch.from_numpy(rs)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("C,G,vec", [(320, 32, 8), (640, 32, 4), (20, 4, 4), (32, 32, 8)])
def test_apply_prologue_merge_matches_merge_group_stats(C, G, vec, S):
    """The apply's in-prologue merge, channel by channel, gives
    ``merge_group_stats``' mean bit for bit and its rstd within 2 ulp (the
    reciprocal square root is rounded once by torch, twice here)."""
    x = t(randn((2, 16 * S, C), 21, 3.0)) + 1.0
    parts = torch.stack([gn_ops.plain_group_norm_partials(s, G) for s in x.chunk(S, dim=1)])
    mu, rs = emulate_apply_constants(parts, C, vec, 1e-5)
    want = gn_ops.merge_group_stats(parts, 1e-5).repeat_interleave(C // G, dim=1)
    assert torch.equal(mu, want[..., 0])
    torch.testing.assert_close(rs, want[..., 1], atol=0.0, rtol=3e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("B,N,C,G", [(2, 64, 64, 32), (4, 32, 1280, 32), (2, 64, 20, 4)])
def test_plain_apply_of_gathered_partials_matches_group_norm(B, N, C, G, n, dtype):
    """``plain_group_norm_apply`` of n slices' gathered partials gives
    ``plain_group_norm`` of the whole (fp32 within 1e-5; bf16 within one
    bf16 spacing of the output, 1e-2 relative); ``group_norm_apply`` on
    CPU tensors takes it, counts no launch and returns the merged
    statistics on request."""
    x = (t(randn((B, N, C), 31, 3.0)) + 1.5).to(dtype)
    w = (t(randn((C,), 32)) + 1).to(dtype)
    b = t(randn((C,), 33)).to(dtype)
    want = gn_ops.plain_group_norm(x, w, b, G, 1e-5, True)
    slices = x.chunk(n, dim=1)
    parts = torch.stack([gn_ops.group_norm_partials(s, G) for s in slices])
    before = (gn_ops.group_norm_partials.launches, gn_ops.group_norm_apply.launches)
    got = torch.cat([gn_ops.plain_group_norm_apply(s, parts, w, b, 1e-5, True) for s in slices],
                    dim=1)
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    y, stats = gn_ops.group_norm_apply(slices[0], parts, w, b, 1e-5, True, return_stats=True)
    assert torch.equal(y, gn_ops.plain_group_norm_apply(slices[0], parts, w, b, 1e-5, True))
    assert torch.equal(stats, gn_ops.merge_group_stats(parts, 1e-5))
    assert (gn_ops.group_norm_partials.launches, gn_ops.group_norm_apply.launches) == before


def test_apply_refuses_partials_of_another_shape():
    x = torch.zeros(2, 8, 64)
    w, b = torch.ones(64), torch.zeros(64)
    for bad in (torch.zeros(2, 32, 3), torch.zeros(1, 3, 32, 3), torch.zeros(1, 2, 32, 2),
                torch.zeros(1, 2, 24, 3), torch.zeros(0, 2, 32, 3)):
        with pytest.raises(ValueError, match="parts"):
            gn_ops.group_norm_apply(x, bad, w, b, 1e-5)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_emulated_split_pair_matches_pallas_kernel(n, silu):
    """The pair as n seq ranks run it (each slice's partials as the kernel
    sums them, gathered, merged and applied) against the JAX package's
    Pallas kernel in interpret mode, whose grid walks the rows in blocks
    of 16 on its pass axis: fp32 within 1e-4 (the Pallas kernel takes
    E[x^2] - mean^2, one more rounding on inputs of mean ~1, std ~3)."""
    B, H, W, C, G = 2, 8, 8, 64, 32
    x = randn((B, H, W, C), 41, 3.0) + 1.0
    w, b = randn((C,), 42, 0.5) + 1.0, randn((C,), 43, 0.5)
    rows = t(x).reshape(B, H * W, C)
    parts = torch.stack([emulate_partials(s.contiguous(), G, gn_ops.partials_plan(
        B, s.shape[1], C, G, 4)) for s in rows.chunk(n, dim=1)])
    got = torch.cat([gn_ops.plain_group_norm_apply(s, parts, t(w), t(b), 1e-5, silu)
                     for s in rows.chunk(n, dim=1)], dim=1).reshape(B, H, W, C)
    want = pallas_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=G, eps=1e-5,
                             silu=silu, block_rows=16, interpret=True)
    assert_close(got, want, 1e-4)


def test_trace_symbols_name_the_kernels():
    """Every trace symbol names a __global__ kernel of ops/csrc, and the
    one-launch kernel has no statistics-only mode left."""
    csrc = Path(gn_ops.__file__).resolve().parent / "csrc"
    source = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
    kernels = set(re.findall(r"__global__ void(?: __launch_bounds__\((?:[^()]|\([^()]*\))*\))?"
                             r"(?:\s*//[^\n]*)?\s+(\w+)\(", source))
    for sym in (*SYMBOLS.values(), *SPLIT_SYMBOLS.values()):
        assert sym in kernels, (sym, kernels)
    assert "kPartials" not in source
