"""The port's kernel wrappers: dispatch, CPU fallback to the plain
versions, argument checks, and (on a GPU) each hand-written CUDA kernel
against its plain version.

Imports torch and the port only, so it also runs on a GPU machine without
JAX:  python -m pytest tests/test_torch_kernels.py -q --noconftest
"""

import collections
import functools
import importlib.util
import math
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_torch.ops import _build
from sonicdiffusionbayeslab_torch.ops import attention as attn_ops
from sonicdiffusionbayeslab_torch.ops import flash_attention as fa
from sonicdiffusionbayeslab_torch.ops import groupnorm as gn_ops
from sonicdiffusionbayeslab_torch.ops import quant as quant_ops
from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention
from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall


def randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def assert_close(got, want, atol, rtol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=atol, rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the GPU")
    return torch.device("cuda")


def traced_kernel_counts(run, symbols):
    """Executions on the card of the kernels whose names hold each symbol,
    during ``run()``, from a torch.profiler trace (graph replays included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [sum(sym in n for n in names) for sym in symbols]


def test_attention_dispatch_rule():
    q = torch.zeros(1, 4, 8, 40)
    assert attn_ops.uses_kernel(q)
    assert not attn_ops.uses_kernel(q, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
    assert not attn_ops.uses_kernel(torch.zeros(1, 4, 1, 512))  # the VAE's mid attention
    assert not attn_ops.uses_kernel(torch.zeros(1, 4, 2, 36))  # head_dim not a multiple of 8


def test_kernel_wrappers_take_plain_path_on_cpu_and_count_nothing():
    q = randn((1, 16, 2, 8), 6)
    counters = (fa.flash_attention_sm90, fa.flash_attention_tf32x3, gn_ops.group_norm_silu)
    before = [f.launches for f in counters]
    assert torch.equal(flash_attention(q, q, q), attn_ops.plain_attention(q, q, q))
    qb = q.to(torch.bfloat16)
    assert torch.equal(flash_attention(qb, qb, qb), attn_ops.plain_attention(qb, qb, qb))
    x, w, b = randn((1, 4, 4, 32), 7), torch.ones(32), torch.zeros(32)
    assert torch.equal(gn_ops.group_norm_silu(x, w, b), gn_ops.plain_group_norm(x, w, b, 32, 1e-5, True))
    assert [f.launches for f in counters] == before


def test_kernel_wrappers_refuse_other_devices():
    q = torch.zeros(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn_ops.group_norm_silu(x, torch.ones(32, device="meta"), torch.zeros(32, device="meta"))


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "sm90"), (torch.float32, "tf32x3")])
def test_attention_kernel_dispatch_by_dtype(dtype, kernel):
    # The rule is the dtype alone: the bf16 kernel is instantiated for every
    # head_dim the wrapper takes (a multiple of 8, at most 160).
    assert fa.kernel_for(dtype) == kernel
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        assert attn_ops.uses_kernel(torch.zeros(1, 4, 2, d, dtype=dtype))
    assert not attn_ops.uses_kernel(torch.zeros(1, 4, 2, fa.MAX_HEAD_DIM + 8, dtype=dtype))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.kernel_for(torch.float16)


# (B, H, N) of every main-path attention (batch 4 whole, 2 per microbatch)
# and some ragged ones.
@pytest.mark.parametrize("B,H,N", [(4, 8, 4096), (4, 8, 1024), (4, 8, 256), (4, 8, 64),
                                   (2, 8, 4096), (2, 8, 1024), (2, 8, 256), (2, 8, 64),
                                   (2, 2, 1000), (1, 1, 33), (2, 8, 300)])
def test_query_tile_plan_covers_rows_and_fills_sms(B, H, N):
    rows = fa.query_tile_rows(B, H, N)
    assert rows in (64, 128)
    blocks = B * H * -(-N // rows)
    assert blocks * rows >= N * B * H and -(-N // rows) * rows - N < rows  # every row, no empty tile
    if B * H * -(-N // 64) >= fa.SM_COUNT:
        assert blocks >= fa.SM_COUNT  # the grid fills the card where it can
    if rows == 64:
        assert B * H * -(-N // 128) < fa.SM_COUNT  # 128 rows only where that would not fill it


def test_tma_layout_check():
    bf = torch.bfloat16
    qkv = torch.zeros(2, 100, 3, 8, 40, dtype=bf)
    assert all(fa.layout_error(t) is None for t in qkv.unbind(2))  # fused-projection views
    assert fa.layout_error(torch.zeros(1, 77, 1, 40, dtype=bf)) is None
    wide = torch.zeros(2, 64, 8, 48, dtype=bf)
    assert "aligned" in fa.layout_error(wide[..., 1:41])  # 2-byte offset
    odd = torch.zeros(2, 64, 8, 44, dtype=bf)[..., :40]  # head stride 88 bytes
    assert "multiples of 16 bytes" in fa.layout_error(odd)
    # A size-1 axis is never stepped along: its stride does not matter.
    one = torch.zeros(1, 64, 8, 44, dtype=bf)[:, :, :1, :40]
    assert fa.layout_error(one) is None
    assert fa._copy_strides(one) == (64 * 40, 352, 40)


def test_fp32_layout_check():
    # The fp32 kernel's cp.async copies need what TMA needs: 16-byte aligned
    # rows, strides that are multiples of 16 bytes (4 elements).
    qkv = torch.zeros(2, 100, 3, 8, 40)
    assert all(fa.layout_error(t) is None for t in qkv.unbind(2))  # fused-projection views
    assert fa.layout_error(torch.zeros(2, 64, 8, 8)) is None  # the tiny configs' D=8
    wide = torch.zeros(2, 64, 8, 44)
    assert "aligned" in fa.layout_error(wide[..., 1:41])  # 4-byte offset
    assert fa.layout_error(wide[..., 4:44]) is None  # 16 bytes in, stride 44: aligned
    odd = torch.zeros(2, 64, 8, 42)[..., :40]  # head stride 168 bytes
    assert "multiples of 16 bytes" in fa.layout_error(odd)


def test_build_digest_tracks_headers_and_flags(tmp_path, monkeypatch):
    for src in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        shutil.copy(src, tmp_path / src.name)
    first = _build.digest(tmp_path)
    assert first == _build.digest(_build.CSRC)
    header = tmp_path / "wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.digest(tmp_path)
    assert edited != first
    monkeypatch.setattr(_build, "LINK_FLAGS", _build.LINK_FLAGS + ["-lm"])
    assert _build.digest(tmp_path) != edited


def test_wgmma_header_matches_its_generator():
    spec = importlib.util.spec_from_file_location("gen_wgmma", _build.CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (_build.CSRC / "wgmma.cuh").read_text() == gen.render()


def test_graphed_call_keeps_only_the_last_signature(monkeypatch):
    # The capture itself needs a GPU; its bookkeeping does not.
    graphs = []

    class Graph:
        def replay(self):
            pass

    def capture(self, args):
        graphs.append(Graph())
        static_in = [a.clone() for a in args]
        return graphs[-1], static_in, self.fn(*static_in)

    monkeypatch.setattr(GraphedCall, "_capture", capture)
    call = GraphedCall(lambda x: x * 2)
    a, b = torch.ones(2), torch.ones(3)
    assert torch.equal(call(a), a * 2) and torch.equal(call(a), a * 2)
    first = weakref.ref(graphs.pop())
    assert first() is not None and not graphs  # one capture for one signature
    assert torch.equal(call(b), b * 2)
    assert first() is None  # the first graph (and with it its pool) is gone
    second = weakref.ref(graphs.pop())
    call(a)
    assert second() is None and len(graphs) == 1
    call.clear()
    assert call.graph is None


# (B, N, C, eps, silu) of every GroupNorm of the main path's whole-batch
# run (UNet at batch 4, VAE decode at batch 2; G = 32), then the tiny
# configs' widths (C = 16 takes gcd(16, 32) = 16 groups of one channel).
GN_MAIN_PATH = [
    (2, 4096, 512, 1e-6, False), (2, 4096, 512, 1e-6, True), (2, 16384, 512, 1e-6, True),
    (2, 65536, 256, 1e-6, True), (2, 65536, 512, 1e-6, True), (2, 262144, 128, 1e-6, True),
    (2, 262144, 256, 1e-6, True), (4, 64, 1280, 1e-6, False), (4, 64, 1280, 1e-5, True),
    (4, 64, 2560, 1e-5, True), (4, 256, 640, 1e-5, True), (4, 256, 1280, 1e-6, False),
    (4, 256, 1280, 1e-5, True), (4, 256, 1920, 1e-5, True), (4, 256, 2560, 1e-5, True),
    (4, 1024, 320, 1e-5, True), (4, 1024, 640, 1e-6, False), (4, 1024, 640, 1e-5, True),
    (4, 1024, 960, 1e-5, True), (4, 1024, 1280, 1e-5, True), (4, 1024, 1920, 1e-5, True),
    (4, 4096, 320, 1e-6, False), (4, 4096, 320, 1e-5, True), (4, 4096, 640, 1e-5, True),
    (4, 4096, 960, 1e-5, True),
]
GN_TINY = [(2, 64, 16, 1e-5, True), (2, 64, 32, 1e-5, True), (2, 256, 64, 1e-6, False)]
# The VAE encoder's GroupNorms not in the lists above: SD-1.5's at 512^2,
# batch 2 (img2img) and SDXL's at 1024^2, batch 1.
GN_ENCODER = [
    (2, 65536, 128, 1e-6, True), (2, 16384, 256, 1e-6, True), (2, 4096, 512, 1e-6, True),
    (1, 1048576, 128, 1e-6, True), (1, 262144, 128, 1e-6, True), (1, 262144, 256, 1e-6, True),
    (1, 65536, 256, 1e-6, True), (1, 65536, 512, 1e-6, True), (1, 16384, 512, 1e-6, True),
    (1, 16384, 512, 1e-6, False),
]
# (B, N, C, eps, silu) of every GroupNorm of the SD-2.1 768^2 and SDXL
# 1024^2 CLI runs (UNet at batch 16, VAE decode at batch 8; G = 32), up
# to SDXL's decoder at 1024 x 1024 rows a sample.
GN_SD21_SDXL = [
    (8, 9216, 512, 1e-6, False), (8, 9216, 512, 1e-6, True), (8, 16384, 512, 1e-6, False),
    (8, 16384, 512, 1e-6, True), (8, 36864, 512, 1e-6, True), (8, 65536, 512, 1e-6, True),
    (8, 147456, 256, 1e-6, True), (8, 147456, 512, 1e-6, True), (8, 262144, 256, 1e-6, True),
    (8, 262144, 512, 1e-6, True), (8, 589824, 128, 1e-6, True), (8, 589824, 256, 1e-6, True),
    (8, 1048576, 128, 1e-6, True), (8, 1048576, 256, 1e-6, True), (16, 144, 1280, 1e-6, False),
    (16, 144, 1280, 1e-5, True), (16, 144, 2560, 1e-5, True), (16, 576, 640, 1e-5, True),
    (16, 576, 1280, 1e-6, False), (16, 576, 1280, 1e-5, True), (16, 576, 1920, 1e-5, True),
    (16, 576, 2560, 1e-5, True), (16, 1024, 640, 1e-5, True), (16, 1024, 1280, 1e-6, False),
    (16, 1024, 1280, 1e-5, True), (16, 1024, 1920, 1e-5, True), (16, 1024, 2560, 1e-5, True),
    (16, 2304, 320, 1e-5, True), (16, 2304, 640, 1e-6, False), (16, 2304, 640, 1e-5, True),
    (16, 2304, 960, 1e-5, True), (16, 2304, 1280, 1e-5, True), (16, 2304, 1920, 1e-5, True),
    (16, 4096, 320, 1e-5, True), (16, 4096, 640, 1e-6, False), (16, 4096, 640, 1e-5, True),
    (16, 4096, 960, 1e-5, True), (16, 4096, 1280, 1e-5, True), (16, 4096, 1920, 1e-5, True),
    (16, 9216, 320, 1e-6, False), (16, 9216, 320, 1e-5, True), (16, 9216, 640, 1e-5, True),
    (16, 9216, 960, 1e-5, True), (16, 16384, 320, 1e-5, True), (16, 16384, 640, 1e-5, True),
    (16, 16384, 960, 1e-5, True),
]


def check_plan(p, B, N, C, G, elem):
    """Every (batch, group) in exactly one cluster, every row in exactly one
    block of it, and a layout the kernel's entry point accepts."""
    gs = C // G
    assert p.channels == p.range_groups * gs and p.ranges * p.range_groups == G
    owners = collections.Counter()
    for b in range(B):
        for r in range(p.ranges):
            for g in range(r * p.range_groups, (r + 1) * p.range_groups):
                owners[(b, g)] += 1
    assert len(owners) == B * G and set(owners.values()) == {1}
    spans = [(k * p.rows, min(N, (k + 1) * p.rows)) for k in range(p.cluster)]
    assert spans[0][0] == 0 and spans[-1][1] == N
    assert all(lo < hi for lo, hi in spans)  # no block without rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # no row twice or missed
    assert 1 <= p.cluster <= gn_ops.MAX_CLUSTER <= 16  # 8 portable, 16 where the card holds it
    assert p.cluster & (p.cluster - 1) == 0
    assert p.ctas == B * p.ranges * p.cluster
    assert p.channels % p.vec == 0 and (p.vec == 1 or p.vec * elem == 16)
    slots = p.channels // p.vec
    assert p.row_lanes & (p.row_lanes - 1) == 0
    assert p.threads % 32 == 0 and 32 <= p.threads <= gn_ops.MAX_THREADS
    assert p.row_lanes * slots <= p.threads or p.row_lanes == 1
    assert p.smem == gn_ops._smem(p.row_lanes, p.channels, p.range_groups, p.rows, elem, p.cache)
    assert p.smem <= gn_ops.MAX_SMEM <= 227 * 1024
    assert p.cache == (p.rows * p.channels * elem <= gn_ops.CACHE_BYTES)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,N,C,eps,silu", GN_MAIN_PATH + GN_TINY + GN_SD21_SDXL)
def test_groupnorm_plan_covers_groups_and_rows(B, N, C, eps, silu, elem):
    G = gn_ops.resolve_groups(C, 32)
    p = gn_ops.plan(B, N, C, G, elem)
    check_plan(p, B, N, C, G, elem)
    # Every SD-1.5, SD-2.1 and SDXL level has an even C / G: 16-byte
    # vectors throughout.
    assert p.vec == 16 // elem
    assert p.channels * elem >= min(gn_ops.MIN_ROW_BYTES, C * elem)  # wide rows where C allows
    if B * N * C * elem >= gn_ops.TARGET_CTAS * gn_ops.MIN_CTA_BYTES:
        assert p.ctas >= 128  # the shape has the work to fill the card: it does
    if (B, N) == (4, 64):
        assert p.cluster == 1 or elem == 4  # the 8x8 level: one block a (b, group range)
    unaligned = gn_ops.plan(B, N, C, G, elem, aligned=False)
    check_plan(unaligned, B, N, C, G, elem)
    assert unaligned.vec == 1


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,N,C,eps,silu", GN_ENCODER)
def test_groupnorm_plan_fills_the_card_at_the_encoders_shapes(B, N, C, eps, silu, elem):
    """The encoder's shapes, one image at 128 channels among them: every
    group and row covered, and 128 blocks, with channel ranges narrower
    than MIN_ROW_BYTES only where the wider ones cannot fill the card, and
    never below a 32-byte sector."""
    G = gn_ops.resolve_groups(C, 32)
    p = gn_ops.plan(B, N, C, G, elem)
    check_plan(p, B, N, C, G, elem)
    assert p.vec == 16 // elem and p.ctas >= gn_ops.TARGET_CTAS
    assert p.channels * elem >= gn_ops.SECTOR_BYTES
    if p.channels * elem < gn_ops.MIN_ROW_BYTES:
        gs = C // G
        for k in range(1, G + 1):
            if G % k == 0 and k * gs * elem >= gn_ops.MIN_ROW_BYTES:
                assert B * (G // k) * gn_ops.MAX_CLUSTER < gn_ops.TARGET_CTAS


@pytest.mark.parametrize("C,G", [(20, 4), (48, 16), (640, 32), (gn_ops.MAX_CHANNELS, 1),
                                 (gn_ops.MAX_CHANNELS - 1, 1), (gn_ops.MAX_CHANNELS, gn_ops.MAX_CHANNELS)])
@pytest.mark.parametrize("N", [1, 7, 4096])
def test_groupnorm_plan_fits_shared_memory_up_to_max_channels(C, G, N):
    # MAX_CHANNELS is what the kernel's shared memory allows: a plan exists
    # for a single group that wide, scalar or vector, in both dtypes.
    for elem in (2, 4):
        for aligned in (True, False):
            check_plan(gn_ops.plan(2, N, C, G, elem, aligned), 2, N, C, G, elem)
    if G == 1:
        assert gn_ops._smem(1, 2 * gn_ops.MAX_CHANNELS, 1, 1, 4, False) > gn_ops.MAX_SMEM


def emulate_kernel_statistics(x, G, p):
    """The kernel's statistics, step by step in float32: per-thread Welford
    over each row lane, the block's tree over lanes, channels folded into
    groups, then Chan merges of the blocks' partials in rank order.
    Returns mean, var [B, G]."""
    B, N, C = x.shape
    gs = C // G

    def chan(a, b):  # (n, mean, M2) pairs; counts as tensors
        (na, ma, qa), (nb, mb, qb) = a, b
        n = na + nb
        safe = torch.where(n > 0, n, torch.ones_like(n))
        d = mb - ma
        m = torch.where(nb > 0, ma + d * (nb / safe), ma)
        q = torch.where(nb > 0, qa + qb + d * d * (na * nb / safe), qa)
        return n, m, q

    def lane_rows(rows, lanes, m):  # rows r < rows with r % m == l, for l < lanes
        l = torch.arange(lanes, dtype=torch.float32)
        return torch.where(l < rows, torch.floor((rows - l + m - 1) / m), torch.zeros(()))

    mean = torch.empty(B, G)
    var = torch.empty(B, G)
    L = p.row_lanes
    for b in range(B):
        for r in range(p.ranges):
            cols = slice(r * p.channels, (r + 1) * p.channels)
            total = (torch.zeros(p.range_groups),) * 3
            for k in range(p.cluster):
                rows = x[b, k * p.rows:min(N, (k + 1) * p.rows), cols]
                n_rows = rows.shape[0]
                m = torch.zeros(L, p.channels)
                q = torch.zeros(L, p.channels)
                for i in range(-(-n_rows // L)):
                    v = rows[i * L:(i + 1) * L]
                    j = v.shape[0]
                    d = v - m[:j]
                    m[:j] = m[:j] + d * torch.tensor(1.0 / (i + 1), dtype=torch.float32)
                    q[:j] = q[:j] + d * (v - m[:j])
                s = L // 2  # lane l takes lane l + s, s = L / 2, ..., 1
                while s:
                    cnt = lane_rows(n_rows, 2 * s, 2 * s)[:, None]
                    _, m[:s], q[:s] = chan((cnt[:s], m[:s], q[:s]),
                                           (cnt[s:], m[s:2 * s], q[s:2 * s]))
                    s //= 2
                cm = m[0].reshape(p.range_groups, gs)
                mu = cm.sum(1) / gs
                qg = (q[0].reshape(p.range_groups, gs) + n_rows * (cm - mu[:, None]) ** 2).sum(1)
                total = chan(total, (torch.full((p.range_groups,), float(n_rows * gs)), mu, qg))
            g = slice(r * p.range_groups, (r + 1) * p.range_groups)
            mean[b, g] = total[1]
            var[b, g] = total[2] / total[0]
    return mean, var


@pytest.mark.parametrize("B,N,C,G,cluster", [
    (2, 64, 64, 32, 1), (2, 300, 64, 32, 4), (1, 1000, 320, 32, 8), (2, 37, 20, 4, 2),
    (1, 4096, 128, 32, 8),
])
def test_groupnorm_plan_merge_order_matches_two_pass(B, N, C, G, cluster):
    x = (randn((B, N, C), 11) * 3 + 1) * torch.linspace(0.5, 2.0, C)
    for p in {gn_ops.plan(B, N, C, G, 4),
              gn_ops._layout(B, N, C, G, 4, 4 if C % 4 == 0 and (C // G) % 2 == 0 else 1,
                             G // 2 if G > 1 else 1, cluster)}:
        check_plan(p, B, N, C, G, 4)
        mean, var = emulate_kernel_statistics(x, G, p)
        xd = x.double().reshape(B, N, G, C // G)
        want_mean = xd.mean(dim=(1, 3))
        want_var = ((xd - want_mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
        torch.testing.assert_close(mean.double(), want_mean, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(var.double(), want_var, atol=0, rtol=1e-5)
        # y from these statistics is plain_group_norm's y.
        w, b = randn((C,), 12) * 0.5 + 1, randn((C,), 13) * 0.5
        xg = x.reshape(B, N, G, C // G)
        y = ((xg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + 1e-5))
        y = y.reshape(B, N, C) * w + b
        assert_close(y * torch.sigmoid(y), gn_ops.plain_group_norm(x, w, b, G, 1e-5, True),
                     2e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_attention_kernel_matches_plain(cuda, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for B, N, M, H, D in [(2, 1000, 1000, 2, 40), (2, 300, 77, 8, 40), (1, 64, 64, 8, 160)]:
        q = torch.randn(B, N, H, D, generator=gen, device=cuda).to(dtype)
        k = torch.randn(B, M, H, D, generator=gen, device=cuda).to(dtype)
        v = torch.randn(B, M, H, D, generator=gen, device=cuda).to(dtype)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert_close(got, attn_ops.plain_attention(q, k, v), atol, 2e-2)
    qkv = torch.randn(2, 500, 3, 8, 40, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)  # non-contiguous views of one fused projection
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


def fp32_attention_inputs(B, N, M, H, D, device, seed=0):
    """q, k, v with q scaled by 3 (logits of standard deviation 3), so that
    the running max moves from K/V tile to K/V tile."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, L, H, D, generator=gen, device=device) * s
            for L, s in ((N, 3), (M, 1), (M, 1))]


def assert_fp32_gate(got, want):
    """The fp32 attention gate of chip_smoke.py: |err| <= 2e-5 + 1e-4 |ref|."""
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (err <= 2e-5 + 1e-4 * want.abs()).all(), f"max abs err {err.max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 200, 200, 2, 8), (2, 200, 200, 2, 16), (2, 200, 200, 2, 24), (2, 256, 256, 4, 40),
    (2, 256, 256, 4, 80), (2, 256, 256, 4, 160), (1, 33, 45, 2, 80), (2, 300, 77, 8, 40),
    (2, 1000, 1000, 2, 40), (2, 64, 77, 8, 160), (4, 1024, 77, 8, 80), (4, 4096, 4096, 8, 40),
    (8, 197, 197, 12, 64), (2, 17, 17, 2, 16),  # the CLIP score's ViT-B/16 and tiny towers
    # ImageReward's BLIP ViT-L/16 and BERT cross-attention (35 queries over
    # the 197 image tokens), and the aesthetic score's CLIP ViT-L/14
    (8, 197, 197, 16, 64), (8, 35, 197, 12, 64), (8, 257, 257, 16, 64),
])
def test_tf32x3_attention_kernel_matches_plain(cuda, monkeypatch, B, N, M, H, D):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # the plain side in fp32
    q, k, v = fp32_attention_inputs(B, N, M, H, D, cuda)
    n0 = fa.flash_attention_tf32x3.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_tf32x3.launches == n0 + 1
    assert_fp32_gate(got, attn_ops.plain_attention(q, k, v))


@pytest.mark.cuda
def test_tf32x3_attention_strided_repeatable_and_graph_capturable(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    for N, H, D in [(1000, 8, 40), (256, 4, 80), (77, 2, 160)]:
        qkv = torch.randn(2, N, 3, H, D, generator=gen, device=cuda)
        q, k, v = qkv.unbind(2)  # non-contiguous views of one fused projection
        q.mul_(3)
        call = lambda: fa.flash_attention_tf32x3(q, k, v)  # noqa: E731
        first = call()
        assert torch.equal(first, fa.flash_attention_tf32x3(q.contiguous(), k.contiguous(),
                                                            v.contiguous()))
        assert torch.equal(call(), first)  # two calls, the same bits
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)  # the graphed launch gives the eager bits


@pytest.mark.cuda
def test_tf32x3_attention_refuses_unaligned_views(cuda):
    wide = torch.zeros(2, 64, 4, 44, device=cuda)
    q = wide[..., 4:44]
    assert fa.layout_error(q) is None
    n0 = fa.flash_attention_tf32x3.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(wide[..., 1:41], q, q)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention(q, torch.zeros(2, 64, 4, 42, device=cuda)[..., :40], q)
    assert fa.flash_attention_tf32x3.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 256, 256, 4, 40), (2, 256, 256, 4, 64), (2, 256, 256, 4, 80), (2, 256, 256, 4, 160),
    (2, 1000, 1000, 2, 40), (2, 300, 77, 8, 40), (1, 33, 45, 2, 80), (2, 64, 64, 8, 160),
    (2, 64, 77, 8, 160), (4, 1024, 77, 8, 80), (1, 200, 130, 3, 24), (4, 4096, 4096, 8, 40),
    # Token Merging's 64x64 self-attention at ratios 0.5 and 0.25 (UNet batch 8).
    (8, 2048, 2048, 8, 40), (8, 3072, 3072, 8, 40),
])
def test_bf16_attention_kernel_matches_plain(cuda, B, N, M, H, D):
    gen = torch.Generator(device=cuda).manual_seed(0)
    # q scaled by 3: logits of standard deviation 3, so the running max
    # moves from K/V tile to K/V tile and O's rescale matters.
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device=cuda).mul(s).to(torch.bfloat16)
               for L, s in ((N, 3), (M, 1), (M, 1)))
    n0 = fa.flash_attention_sm90.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_sm90.launches == n0 + 1
    want = attn_ops.plain_attention(q, k, v).float()
    err = (got.float() - want).abs()
    assert (err <= 1e-2 + 2e-2 * want.abs()).all(), f"max abs err {err.max().item():.3e}"
    rms = want.pow(2).mean().sqrt().item()
    assert err.max().item() <= 0.1 * rms, f"max abs err {err.max().item():.3e}, rms {rms:.3e}"


@pytest.mark.cuda
def test_flops_estimate_counts_the_bf16_kernel(cuda):
    """FlopCounterMode cannot see the kernel's ctypes launch: its wrapper
    adds the two products' 4·B·H·N·M·D itself, once a launch."""
    from sonicdiffusionbayeslab_torch.utils.profiling import flops_estimate

    B, N, M, H, D = 2, 1024, 77, 8, 40
    q, k, v = (torch.randn(B, L, H, D, device=cuda, dtype=torch.bfloat16) for L in (N, M, M))
    n0 = fa.flash_attention_sm90.launches
    assert flops_estimate(flash_attention, q, k, v) == {"flops": 4 * B * H * N * M * D}
    assert fa.flash_attention_sm90.launches == n0 + 1


# The SD-2.1 768^2 and SDXL 1024^2 UNets' attention shapes (head_dim 64),
# at batch 2 in place of the CLI runs' 16.
D64_SHAPES = [(2, 9216, 9216, 5, 64), (2, 2304, 2304, 10, 64), (2, 576, 576, 20, 64),
              (2, 144, 144, 20, 64), (2, 9216, 77, 5, 64), (2, 144, 77, 20, 64),
              (2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64), (2, 4096, 77, 10, 64),
              (2, 1024, 77, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("B,N,M,H,D", D64_SHAPES)
def test_bf16_attention_d64_matches_plain(cuda, B, N, M, H, D, layout):
    """Contiguous [B, N, H, D] tensors, or the strided views of fused
    projections the UNet's layers would give (q of [B, N, H, D]; k, v of
    one [B, M, 2, H, D]): within the bf16 elementwise gate of the plain
    version, and the max error within 0.1 x rms(plain) or one bf16 spacing
    at the largest |plain|, whichever is larger.  Both sides round their
    outputs to bf16, so one spacing is the least they can differ by where
    they round apart; with 4096 keys and logits of standard deviation 3 the
    softmax is peaked enough that the largest output passes 4 (spacing
    2^-5) while the rms stays near 0.28."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, N, H, D, generator=gen, device=cuda).mul(3).to(torch.bfloat16)
    if layout == "contiguous":
        k, v = (torch.randn(B, M, H, D, generator=gen, device=cuda).to(torch.bfloat16)
                for _ in range(2))
    else:
        k, v = torch.randn(B, M, 2, H, D, generator=gen, device=cuda).to(torch.bfloat16).unbind(2)
    n0 = fa.flash_attention_sm90.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_sm90.launches == n0 + 1
    want = attn_ops.plain_attention(q, k, v).float()
    err = (got.float() - want).abs()
    assert (err <= 1e-2 + 2e-2 * want.abs()).all(), f"max abs err {err.max().item():.3e}"
    rms = want.pow(2).mean().sqrt().item()
    spacing = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert err.max().item() <= max(0.1 * rms, spacing), (
        f"max abs err {err.max().item():.3e}, rms {rms:.3e}, bf16 spacing {spacing:.3e}")


# SD3-medium's joint attention (24 heads of 64): image tokens + 77 CLIP
# tokens at 1024^2 (4096 + 77), with T5's 256 more, under ToMe 0.5 and
# 0.25, and at 512^2; ragged in N and M, M spanning many K/V tiles.
JOINT_TOKENS = [4173, 4429, 2125, 3149, 1101]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "projection_views"])
@pytest.mark.parametrize("N", JOINT_TOKENS)
def test_bf16_attention_sd3_joint_shapes_match_plain(cuda, N, layout):
    """The MMDiT's joint shapes at batch 2, [2, N, 24, 64] with N = M:
    contiguous, or q, k and v as views of one concatenated [2, N, 3 * 1536]
    projection; the gates of ``test_bf16_attention_d64_matches_plain``."""
    B, H, D = 2, 24, 64
    gen = torch.Generator(device=cuda).manual_seed(N)
    if layout == "contiguous":
        q, k, v = (torch.randn(B, N, H, D, generator=gen, device=cuda).to(torch.bfloat16)
                   for _ in range(3))
    else:
        qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=cuda).to(torch.bfloat16)
        q, k, v = qkv.view(B, N, 3, H, D).unbind(2)
    q = q * 3
    n0 = fa.flash_attention_sm90.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_sm90.launches == n0 + 1
    want = torch.cat([attn_ops.plain_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                      for i in range(B)]).float()
    err = (got.float() - want).abs()
    assert (err <= 1e-2 + 2e-2 * want.abs()).all(), f"max abs err {err.max().item():.3e}"
    rms = want.pow(2).mean().sqrt().item()
    spacing = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert err.max().item() <= max(0.1 * rms, spacing), (
        f"max abs err {err.max().item():.3e}, rms {rms:.3e}, bf16 spacing {spacing:.3e}")
    if layout == "projection_views":
        assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.cuda
def test_bf16_attention_strided_views_bit_equal(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for N, H, D in [(1000, 8, 40), (256, 4, 80), (64, 2, 160)]:
        qkv = torch.randn(2, N, 3, H, D, generator=gen, device=cuda).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        assert torch.equal(fa.flash_attention_sm90(q, k, v),
                           fa.flash_attention_sm90(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.cuda
def test_bf16_attention_refuses_unaligned_views(cuda):
    wide = torch.zeros(2, 64, 4, 48, dtype=torch.bfloat16, device=cuda)
    q = wide[..., 8:48]
    assert fa.layout_error(q) is None
    n0 = fa.flash_attention_sm90.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(wide[..., 1:41], q, q)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_attention(q, torch.zeros(2, 64, 4, 44, dtype=torch.bfloat16, device=cuda)[..., :40], q)
    assert fa.flash_attention_sm90.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_group_norm_kernel_matches_plain(cuda, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    # One shape of each plan class: clusters of several blocks with rows
    # kept in shared memory (64x64x320) or read again (the VAE's 512x512x128,
    # 64x64x960), a cluster of one (8x8x1280, the UNet's 8x8 level), the
    # tiny configs' 16 groups of one channel, and the scalar path (C = 20).
    for B, H, W, C in [(2, 64, 64, 320), (2, 8, 8, 1280), (1, 128, 128, 128), (2, 8, 8, 16),
                       (4, 8, 8, 1280), (2, 512, 512, 128), (4, 64, 64, 960), (2, 7, 5, 20)]:
        x = (torch.randn(B, H, W, C, generator=gen, device=cuda) * 3 + 1).to(dtype)
        w = torch.randn(C, generator=gen, device=cuda).to(dtype)
        b = torch.randn(C, generator=gen, device=cuda).to(dtype)
        for silu in (True, False):
            got = gn_ops.group_norm_silu(x, w, b, 32, 1e-5, silu)
            want = gn_ops.plain_group_norm(x, w, b, gn_ops.resolve_groups(C, 32), 1e-5, silu)
            torch.cuda.synchronize()
            assert_close(got, want, atol, 1e-2)
        del x, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,N,C", [
    (1, 1024 * 1024, 128), (1, 1024 * 1024, 256),  # SDXL's decoder at 1024^2, one sample
    (2, 9216, 320), (2, 2304, 640), (2, 576, 1280), (2, 144, 2560),  # SD-2.1's UNet at 96^2
    (2, 16384, 320), (2, 16384, 960), (2, 4096, 640), (2, 1024, 1280),  # SDXL's at 128^2
])
def test_group_norm_sd21_sdxl_shapes_match_plain(cuda, B, N, C, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(B, N, C, generator=gen, device=cuda) * 3 + 1).to(dtype)
    w = torch.randn(C, generator=gen, device=cuda).to(dtype)
    b = torch.randn(C, generator=gen, device=cuda).to(dtype)
    for silu in (True, False):
        got = gn_ops.group_norm_silu(x, w, b, 32, 1e-6, silu)
        want = gn_ops.plain_group_norm(x, w, b, 32, 1e-6, silu)
        torch.cuda.synchronize()
        assert_close(got, want, atol, 1e-2)


@pytest.mark.cuda
def test_group_norm_unaligned_view_takes_scalar_path(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    flat = torch.randn(2 * 64 * 320 + 1, generator=gen, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(2, 64, 320)  # 2 bytes past a 16-byte boundary
    assert x.data_ptr() % 16 and gn_ops.plan(2, 64, 320, 32, 2, aligned=False).vec == 1
    w, b = torch.ones(320, device=cuda, dtype=torch.bfloat16), torch.zeros(320, device=cuda,
                                                                            dtype=torch.bfloat16)
    got = gn_ops.group_norm_silu(x, w, b)
    torch.cuda.synchronize()
    assert_close(got, gn_ops.plain_group_norm(x, w, b, 32, 1e-5, True), 3e-2, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 1280), (4, 4096, 320), (2, 262144, 128)])
def test_group_norm_one_launch_deterministic_and_graph_capturable(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    C = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=cuda) * 3 + 1).to(torch.bfloat16)
    w = torch.randn(C, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(C, generator=gen, device=cuda).to(torch.bfloat16)
    call = lambda: gn_ops.group_norm_silu(x, w, b)  # noqa: E731
    first = call()
    n0 = gn_ops.group_norm_silu.launches
    out = []
    traced = traced_kernel_counts(lambda: out.append(call()), ("gn_cluster_kernel",))
    assert traced == [1] and gn_ops.group_norm_silu.launches == n0 + 1  # one kernel a call
    assert torch.equal(out[0], first)  # two calls, the same bits
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)  # the graphed launch gives the eager bits


@pytest.mark.cuda
def test_graphed_unet_matches_eager_and_replays_its_kernels(cuda):
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.bfloat16, device=cuda).init_params(0)
    x = randn((2, 8, 8, 4), 1).to(cuda, torch.bfloat16)
    t = torch.tensor([500.0, 20.0], device=cuda)
    e = randn((2, 77, 32), 2).to(cuda, torch.bfloat16)
    counters = (fa.flash_attention_sm90, gn_ops.group_norm_silu)
    symbols = ("flash_fwd_sm90_kernel", "gn_cluster_kernel")
    with torch.inference_mode():
        before = [f.launches for f in counters]
        traced = traced_kernel_counts(lambda: eng.unet(x, t, e), symbols)
        per_call = [f.launches - b for f, b in zip(counters, before)]
        assert min(per_call) > 0
        assert traced == per_call  # the trace counts what ran: one GroupNorm kernel a call
        want = [eng.unet(x * s, t, e) for s in (1, 2)]
        eng.graphed_unet(x, t, e)  # two eager warm-ups, then the capture and one replay
        before = [f.launches for f in counters]
        got = []
        traced = traced_kernel_counts(lambda: got.extend(eng.graphed_unet(x * s, t, e)
                                                         for s in (1, 2)), symbols)
        assert [f.launches for f in counters] == before  # a replay runs no wrapper
        assert traced == [2 * per_call[0], 2 * per_call[1]]
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_graphed_deep_cache_variants_match_eager(cuda):
    """DeepCache's full call (output and trunk features) and shallow call,
    each replayed from its own graph, give the eager calls' bits; the two
    graphs stay captured once each while the calls alternate."""
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.bfloat16, device=cuda).init_params(0)
    x = randn((2, 8, 8, 4), 1).to(cuda, torch.bfloat16)
    t = torch.tensor([500.0, 20.0], device=cuda)
    e = randn((2, 77, 32), 2).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        out, feats = eng.unet(x, t, e, return_cache=True, cache_branch_id=0)
        shallow = eng.unet(x * 2, t, e, feats, cache_branch_id=0)
        for _ in range(2):
            g_out, g_feats = eng.graphed_unet(x, t, e, return_cache=True, cache_branch_id=0)
            g_shallow = eng.graphed_unet(x * 2, t, e, g_feats, cache_branch_id=0)
            assert torch.equal(g_out, out) and torch.equal(g_feats, feats)
            assert torch.equal(g_shallow, shallow)
    assert sorted(eng.graphed_unet.captures.values()) == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("deep_cache,rand", [(False, True), (True, True), (False, False)])
def test_graphed_tome_matches_eager(cuda, deep_cache, rand):
    """A ToMe UNet call (ratio 0.5) replayed from its graph gives the eager
    call's bits, with each call's random destinations taken as a graph
    input (two steps' draws, alternating) or, without ``rand``, each cell's
    top-left token made on the card; one capture per variant, also with
    DeepCache's full and shallow calls."""
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
    from sonicdiffusionbayeslab_torch.utils.rng import tome_destinations

    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.bfloat16, device=cuda).init_params(0)
    x = randn((2, 8, 8, 4), 1).to(cuda, torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device=cuda)
    e = randn((2, 77, 32), 2).to(cuda, torch.bfloat16)
    tome = TomeConfig(0.5, rand=rand)
    slots = eng.unet.tome_slots(8, 8, tome)
    dsts = [tome_destinations(ts, slots, tome).to(cuda) if rand else None for ts in (500, 480)]
    assert not rand or not torch.equal(dsts[0], dsts[1])
    kw = dict(return_cache=True, cache_branch_id=0) if deep_cache else {}
    with torch.inference_mode():
        want = [eng.unet(x, t, e, None, d, tome=tome, **kw) for d in dsts]
        if deep_cache:
            want_shallow = [eng.unet(x * 2, t, e, w[1], d, tome=tome, cache_branch_id=0)
                            for w, d in zip(want, dsts)]
        for _ in range(2):
            for i, d in enumerate(dsts):
                got = eng.graphed_unet(x, t, e, None, d, tome=tome, **kw)
                if deep_cache:
                    assert all(torch.equal(g, w) for g, w in zip(got, want[i]))
                    shallow = eng.graphed_unet(x * 2, t, e, got[1], d, tome=tome,
                                               cache_branch_id=0)
                    assert torch.equal(shallow, want_shallow[i])
                else:
                    assert torch.equal(got, want[i])
    assert sorted(eng.graphed_unet.captures.values()) == [1] * (2 if deep_cache else 1)


@pytest.mark.cuda
def test_graphed_call_releases_the_previous_graphs_memory(cuda):
    w = torch.randn(2048, 2048, device=cuda)
    call = GraphedCall(lambda x: (x @ w).relu() @ w)  # activations in the graph's pool
    big = torch.randn(16384, 2048, device=cuda)  # 128 MiB, as each activation
    call(big)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    call(big[:64].clone())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= held - 256 * 2**20


@pytest.mark.cuda
def test_attention_kernels_take_only_their_dtype(cuda):
    q = torch.zeros(1, 64, 2, 40, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_sm90(q, q, q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_tf32x3(qb, qb, qb)


# (M, K, N) of int8 GEMMs: full-width SD-1.5 UNet 3x3 convs (im2col rows
# at UNet batch 4; K = 9 C in; N = C out) and small ones that need the zero
# rows and columns of _int_mm's shape rules.
INT8_SHAPES = [(16384, 2880, 320), (4096, 5760, 640), (1024, 11520, 1280), (256, 23040, 1280),
               (1024, 8640, 640), (5, 37, 11), (16, 24, 8), (17, 40, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_matmul_card_bit_equal_to_int64(cuda, M, K, N):
    """cuBLASLt's int8 GEMM (``torch._int_mm``) through the wrapper: its
    int32 sums bit-equal to int64 sums on the CPU (first 64 rows) and to a
    float64 product on the card, where every partial sum is an integer
    below 2^53; one launch counted."""
    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    n0 = quant_ops.int8_matmul.launches
    got = quant_ops.int8_matmul(a.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert quant_ops.int8_matmul.launches == n0 + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    rows = min(M, 64)
    assert torch.equal(got[:rows].cpu().long(), a[:rows].long() @ w.long().t())
    assert torch.equal(got.double(), a.to(cuda).double() @ w.to(cuda).double().t())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stride,pad", [((2, 64, 64, 320), (1, 1), ((1, 1), (1, 1))),
                                              ((2, 16, 16, 640), (2, 2), ((1, 1), (1, 1))),
                                              ((1, 7, 9, 8), (2, 2), ((0, 1), (0, 1)))])
def test_int8_conv_and_dense_card_bit_equal_to_cpu(cuda, shape, stride, pad):
    """``int8_conv`` (im2col + the int8 GEMM) and ``int8_dense`` on the card
    against their plain versions on the CPU, fp32: the same int8 operands,
    exact int32 sums and the same epilogue give the same bits; and a CUDA
    graph of the conv replays them."""
    C = shape[-1]
    x, w, b = randn(shape, 1), randn((C, C, 3, 3), 2) / (3 * C ** 0.5), randn((C,), 3)
    want = quant_ops.int8_conv(x, w, b, stride=stride, padding=pad)
    xc, wc, bc = x.to(cuda), w.to(cuda), b.to(cuda)
    call = lambda: quant_ops.int8_conv(xc, wc, bc, stride=stride, padding=pad)  # noqa: E731
    n0 = quant_ops.int8_conv.launches
    assert torch.equal(call().cpu(), want)
    assert quant_ops.int8_conv.launches == n0 + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.cpu(), want)
    tokens, wd = x.reshape(shape[0], -1, C), randn((C, C), 4) / C ** 0.5
    assert torch.equal(quant_ops.int8_dense(tokens.to(cuda), wd.to(cuda), b.to(cuda)).cpu(),
                       quant_ops.int8_dense(tokens, wd, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact", "trunk_delta", "tome"])
def test_tiny_sd3_engine_card_matches_cpu(cuda, monkeypatch, case):
    """The tiny fp32 SD3 engine (MMDiT, 16-channel VAE, both projected CLIP
    towers), graphed on the card against the same weights on the CPU: 4
    flow Euler steps at CFG 5 from given latents, exact, with the
    trunk-delta cache (interval 2, branch 1) and with DiT-ToMe 0.5 on given
    destinations; images within 1e-3 and one capture per graph variant."""
    from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan, SDXLTextConfigs
    from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine
    from sonicdiffusionbayeslab_torch.models.tokenizer import HashTokenizer
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
    from sonicdiffusionbayeslab_torch.schedulers import FlowMatchEulerScheduler
    from sonicdiffusionbayeslab_torch.utils.rng import tome_destinations

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    engines = [SD3Engine(MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                         dtype=torch.float32, device=d) for d in ("cpu", cuda)]
    engines[0].init_params(0)
    engines[1].load_state_dicts({k: m.state_dict() for k, m in
                                 zip(engines[0].MODULES, engines[0].modules())})
    plan = FlowMatchEulerScheduler(shift=3.0).build_plan(4)
    kw = dict(guidance_scale=5.0, latent_hw=(8, 8), init_latents=randn((2, 8, 8, 16), 3))
    if case == "trunk_delta":
        kw["cache_plan"] = CachePlan.every(4, 2, 1)
    if case == "tome":
        tome = TomeConfig(0.5)
        slots = engines[0].unet.tome_slots(8, 8, tome)
        kw.update(tome=tome, tome_dst=torch.stack([tome_destinations(int(ts), slots, tome)
                                                   for ts in plan.timesteps]))
    out = []
    for eng in engines:
        ids = [HashTokenizer(c.vocab_size, c.max_length)(p)
               for p in (["a cat", "a red boat"], ["", ""])
               for c in (eng.text_config, eng.text2_config)]
        ctx, pooled = eng.encode_prompts_sd3(ids[0], ids[1])
        nctx, npooled = eng.encode_prompts_sd3(ids[2], ids[3])
        added = {"text_embeds": pooled, "negative_text_embeds": npooled,
                 "time_ids": torch.zeros(2, 6)}
        out.append(eng.sample(plan, ctx, nctx, added_cond=added, **kw).images.cpu())
    err = (out[0] - out[1]).abs().max().item()
    assert err <= 1e-3, f"max abs image err {err:.3e}"
    assert sorted(engines[1].graphed_unet.captures.values()) == [1] * (
        2 if case == "trunk_delta" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("D", [40, 80, 160])
def test_bf16_attention_single_partial_kv_tile_matches_plain(cuda, M, D):
    """M < 64: one K/V tile, most of its keys past M (IP-Adapter's four
    image tokens), against the plain version under chip_smoke.py's bf16 gate
    (1e-2 + 2e-2 |ref|, and max |err| <= 0.1 rms); query rows ragged too."""
    gen = torch.Generator(device=cuda).manual_seed(M * D)
    for B, N, H in ((4, 1024, 8), (2, 77, 4)):
        q = (torch.randn(B, N, H, D, generator=gen, device=cuda) * 3).to(torch.bfloat16)
        k, v = (torch.randn(B, M, H, D, generator=gen, device=cuda).to(torch.bfloat16)
                for _ in range(2))
        n0 = fa.flash_attention_sm90.launches
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert fa.flash_attention_sm90.launches == n0 + 1
        want = attn_ops.plain_attention(q, k, v)
        assert torch.isfinite(got).all()
        assert_close(got, want, 1e-2, 2e-2)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 0.1 * want.float().pow(2).mean().sqrt().item()
        if M == 1:  # softmax over one key: the output is v, broadcast
            assert_close(got, v.expand(B, N, H, D), 1e-2, 1e-2)


@pytest.mark.cuda
def test_graphed_controlnet_pipeline_call_matches_eager(cuda):
    """The ControlNet pipeline's denoiser call (the ControlNet's residuals,
    then the UNet with IP-Adapter's tokens) replayed from a CUDA graph is
    bit-equal to the eager call, and the graph takes new control images and
    scales at each replay."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionControlNetModel

    pipe = StableDiffusionControlNetModel(tiny=True, image_size=64, dtype="bfloat16", seed=0,
                                          device=cuda, ip_adapter="random.bin")
    eng = pipe.engine
    with torch.no_grad():
        for conv in eng.controlnet.heads():  # nonzero residuals
            conv.weight.normal_(0.0, 0.05)
    x = randn((4, 8, 8, 4), 1).to(cuda, torch.bfloat16)
    t = torch.tensor([500.0, 500.0, 20.0, 20.0], device=cuda)
    e = randn((4, 77, 32), 2).to(cuda, torch.bfloat16)
    tokens = randn((4, 4, 32), 3).to(cuda, torch.bfloat16)
    hint = torch.rand(4, 64, 64, 3, device=cuda)
    with torch.inference_mode():
        for scale, ip in ((1.0, 0.5), (0.3, 1.0)):
            args = (x, t, e, None, None, None, None, tokens, torch.tensor(ip, device=cuda), hint,
                    torch.tensor(scale, device=cuda))
            want = eng.denoise(*args)
            got = eng.graphed_unet(*args)
            assert torch.equal(got, want)
        bare = eng.unet(x, t, e)
        assert not torch.equal(got, bare)
    assert list(eng.graphed_unet.captures.values()) == [1]


# ------------------------------------------------------------- gradients
# The autograd Functions on the card: the kernel forward (one launch) and
# the stock backward (no launch), against autograd through the plain
# version in fp32 on the same inputs, under chip_smoke.py's GRAD_TOL:
# |grad - ref| <= atol * max|ref| + rtol * |ref|.
@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160),  # SD-1.5's levels
    (1, 4250, 4250, 24, 64),  # the SD3 LoRA bench's joint attention (4096 + 154 tokens)
])
def test_attention_function_gradients_match_plain_on_card(cuda, dtype, B, N, M, H, D):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = ((torch.randn(B, L, H, D, generator=gen, device=cuda) * s).to(dtype)
               for L, s in ((N, 2.0), (M, 1.0), (M, 1.0)))
    do = torch.randn(B, N, H, D, generator=gen, device=cuda).to(dtype)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    launches = fa._KERNELS[fa.kernel_for(dtype)]
    n0 = launches.launches
    o = attn_ops.dot_product_attention(qr, kr, vr)
    assert isinstance(o.grad_fn, fa.FlashAttentionFn._backward_cls)
    got = torch.autograd.grad(o, (qr, kr, vr), do)
    torch.cuda.synchronize()
    assert launches.launches == n0 + 1  # the forward's one launch; none in the backward
    for b in range(B):  # the plain version a batch row at a time (its [H, N, M] fp32 graph)
        ref_in = [x[b:b + 1].float().requires_grad_(True) for x in (q, k, v)]
        ref = torch.autograd.grad(attn_ops.plain_attention(*ref_in), ref_in,
                                  do[b:b + 1].float())
        for g, r in zip(got, ref):
            assert g.dtype == dtype
            _chip_smoke().grad_close(g[b:b + 1], r, dtype, f"attention {b}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(8, 4096, 320), (8, 1024, 640), (8, 64, 1280), (8, 4096, 960)])
def test_group_norm_function_gradients_match_plain_on_card(cuda, dtype, silu, shape):
    gen = torch.Generator(device=cuda).manual_seed(10)
    C = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=cuda) * 3 + 1).to(dtype)
    w = (torch.randn(C, generator=gen, device=cuda) * 0.5 + 1).to(dtype)
    b = (torch.randn(C, generator=gen, device=cuda) * 0.5).to(dtype)
    dy = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    ins = [a.clone().requires_grad_(True) for a in (x, w, b)]
    n0 = gn_ops.group_norm_silu.launches
    y = gn_ops.group_norm_silu(*ins, 32, 1e-5, silu)
    assert isinstance(y.grad_fn, gn_ops.GroupNormSiLUFn._backward_cls)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert gn_ops.group_norm_silu.launches == n0 + 1
    ref_in = [a.float().requires_grad_(True) for a in (x, w, b)]
    ref = torch.autograd.grad(gn_ops.plain_group_norm(*ref_in, 32, 1e-5, silu), ref_in,
                              dy.float())
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        _chip_smoke().grad_close(g, r, dtype, "GroupNorm")


@pytest.mark.cuda
def test_tiny_lora_steps_on_card_match_cpu_and_drop_no_gradient(cuda):
    """Three LoRA and three full fine-tune steps of the tiny fp32 UNet on
    the card (its attention and GroupNorm on the kernels, TF32 off) and on
    the CPU from the same weights, adapters and draws, through
    chip_smoke.py's gate: each step's gradients at the card's state within
    TINY_GRAD_REL of each tensor's max |g|; every b has a gradient at step
    0 and every a from step 1 on (no backward drops one); losses, grad
    norms and the trained tensors within 1e-3, at most 0.1% of the entries
    more than 0.1 x lr apart; only the forwards launch kernels."""
    smoke = _chip_smoke()
    out = smoke.train_tiny_card_vs_cpu(smoke.module_census(2, tiny=True))
    for name, r in out.items():
        assert r["max_grad_rel_err"] <= smoke.TINY_GRAD_REL, name
        assert r["fp32_attention_launches"] > 0 and r["group_norm_launches"] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,M,H,D", [
    (8, 4096, 77, 8, 40),  # textual inversion's first cross-attention: K/V from the text
    (2, 1024, 1024, 8, 80),  # a self-attention shape
])
def test_attention_function_kv_only_gradients_match_plain_on_card(cuda, dtype, B, N, M, H, D):
    """Only K and V require grad (the query holds no path to the trained
    tensors): the Function still runs the kernel once and returns dk and
    dv against autograd through the plain version, under GRAD_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    q, k, v = ((torch.randn(B, L, H, D, generator=gen, device=cuda) * s).to(dtype)
               for L, s in ((N, 2.0), (M, 1.0), (M, 1.0)))
    do = torch.randn(B, N, H, D, generator=gen, device=cuda).to(dtype)
    kr, vr = (x.clone().requires_grad_(True) for x in (k, v))
    launches = fa._KERNELS[fa.kernel_for(dtype)]
    n0 = launches.launches
    o = attn_ops.dot_product_attention(q, kr, vr)
    assert isinstance(o.grad_fn, fa.FlashAttentionFn._backward_cls)
    got = torch.autograd.grad(o, (kr, vr), do)
    torch.cuda.synchronize()
    assert launches.launches == n0 + 1
    for b in range(B):
        ref_in = [x[b:b + 1].float().requires_grad_(True) for x in (k, v)]
        ref = torch.autograd.grad(attn_ops.plain_attention(q[b:b + 1].float(), *ref_in), ref_in,
                                  do[b:b + 1].float())
        for g, r in zip(got, ref):
            assert g.dtype == dtype
            _chip_smoke().grad_close(g[b:b + 1], r, dtype, f"K/V-only attention {b}")


@pytest.mark.cuda
def test_graphed_wcond_unet_matches_eager(cuda):
    """A w-conditioned UNet's graphed call copies its guidance embedding in
    at each replay: two embedded guidance scales, each replay bit-equal to
    the eager call, one capture."""
    import dataclasses

    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import (StableDiffusionEngine,
                                                             guidance_scale_embedding)
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    cfg = dataclasses.replace(UNetConfig.tiny(), time_cond_proj_dim=8)
    eng = StableDiffusionEngine(cfg, VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.bfloat16, device=cuda).init_params(0)
    x = randn((2, 8, 8, 4), 1).to(cuda, torch.bfloat16)
    t = torch.tensor([500.0, 20.0], device=cuda)
    e = randn((2, 77, 32), 2).to(cuda, torch.bfloat16)
    outs = []
    with torch.inference_mode():
        for w in (8.0, 2.0):
            emb = guidance_scale_embedding(torch.full((2,), w - 1.0), 8).to(cuda)
            want = eng.unet(x, t, e, timestep_cond=emb)
            got = eng.graphed_unet(x, t, e, *(None,) * 8, emb)
            assert torch.equal(got, want)
            outs.append(got)
    assert not torch.equal(outs[0], outs[1])
    assert list(eng.graphed_unet.captures.values()) == [1]


@pytest.mark.cuda
def test_tiny_distill_and_ti_steps_on_card_match_cpu(cuda):
    """chip_smoke.py's gate for one LCM-LoRA, one w-conditioned full distill
    step and one textual-inversion step of the tiny fp32 UNet on the card
    against the CPU: gradients within TINY_GRAD_REL, losses within 1e-3,
    only the forwards' launches."""
    smoke = _chip_smoke()
    out = smoke.distill_tiny_card_vs_cpu(smoke.module_census(2, tiny=True))
    assert set(out) == {"distill lora", "distill wcond full", "textual inversion"}
    for name, r in out.items():
        assert r["max_grad_rel_err"] <= smoke.TINY_GRAD_REL, name
