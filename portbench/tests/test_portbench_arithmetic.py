"""The yardstick's arithmetic against hand counts: the rooflines' least
times, the census' FLOPs, the trace's busy and idle time, the per-launch
normalisation and the readers built on them, the DPM-Solver++ ladder."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch import nn

from portbench import run as harness
from portbench.peaks import (
    PEAK_BF16,
    PEAK_BYTES,
    PEAK_EXP,
    PEAK_FP32,
    attention_bound_s,
    group_norm_bound_s,
)
from portbench.record import Record
from portbench.reference import census
from portbench.reference.sample import DPMSolverPP2M
from portbench.trace import Trace, kernel_group


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py", "reader")


def test_attention_bound_by_hand():
    # SD-1.5's first self-attention at 16 rows: 4*16*8*4096*4096*40 FLOP
    # = 3.44e11 at 989e12/s = 0.3475 ms; 16*8*4096^2 exponentials at
    # 3.9e12/s = 0.5506 ms (the larger); bytes (2*16*4096*8*40*2)*2 / 3.35e12.
    exps = 16 * 8 * 4096 * 4096 / 3.9e12
    assert attention_bound_s(16, 4096, 4096, 8, 40) == pytest.approx(exps, rel=1e-12)
    # A cross-attention over 77 tokens at D 160 is bound by bytes.
    nbytes = (2 * 16 * 64 * 8 * 160 + 2 * 16 * 77 * 8 * 160) * 2
    assert attention_bound_s(16, 64, 77, 8, 160) == pytest.approx(nbytes / 3.35e12)
    assert PEAK_BF16 == 989e12 and PEAK_EXP == 3.9e12 and PEAK_BYTES == 3.35e12


def test_group_norm_bound_by_hand():
    # [16, 4096, 320] bf16: 2 * 16 * 4096 * 320 * 2 bytes = 83.9 MB at
    # 3.35 TB/s = 25.04 us; 10 * 20.97e6 ops at 67e12/s = 3.13 us.
    n = 16 * 4096 * 320
    assert group_norm_bound_s(16, 4096, 320, True) == pytest.approx((4 * n + 4 * 320) / 3.35e12)
    assert 10 * n / PEAK_FP32 < group_norm_bound_s(16, 4096, 320, True)
    # A tiny map with many channels per element is bound by operations.
    assert group_norm_bound_s(1, 1, 1, True) == pytest.approx(
        max(10 / PEAK_FP32, 6 / PEAK_BYTES))


def test_census_counts_a_small_network_by_hand():
    from portbench.reference import nets

    class Small(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(4, 8, 3, padding=1)
            self.norm = nets.GroupNorm(8, 4, 1e-5, silu=True)
            self.attn = nets.Attention(8, 2)

        def forward(self, x):
            h = self.norm(self.conv(x))
            B, C, H, W = h.shape
            return self.attn(h.flatten(2).transpose(1, 2))

    with torch.device("meta"):
        net = Small()
    c = census.count(net, torch.empty(2, 4, 5, 5, device="meta"))
    conv = 2 * (2 * 25) * 8 * 4 * 9  # 2 * outputs * input taps
    linears = 4 * 2 * (2 * 25) * 8 * 8  # q, k, v, out
    products = 2 * 2 * (2 * 2 * 25 * 25 * 4)  # q k^T and p v: 2 * B*H*N*M*D each
    gn = 10 * 2 * 8 * 25
    assert c.flops == conv + linears + products + gn
    assert c.calls == {("group_norm", (2, 25, 8, 4, True)): 1,
                       ("attention", (2, 25, 25, 2, 4, False)): 1}


def test_sd15_unet_census_at_16_rows_is_12_86_tflop():
    cfg = harness.load_json(harness.ROOT / "configs" / "sd15.json")
    parts = census.pipeline_census(cfg, 16, 1)
    assert parts["unet"].flops == pytest.approx(12.86e12, rel=5e-4)
    attn = sum(n for (k, _), n in parts["unet"].calls.items() if k == "attention")
    gn = sum(n for (k, _), n in parts["unet"].calls.items() if k == "group_norm")
    assert (attn, gn) == (32, 61)  # 16 transformers of 2 attentions; 61 GroupNorms


def trace(kernels, window):
    return Trace(kernels=kernels, host=[("portbench.call", window[0], window[1], 1),
                                        ("cudaStreamSynchronize", 450, 700, 1)], window=window)


def test_trace_busy_idle_and_gaps_by_hand():
    t = trace([("gn_cluster_kernel", 100, 200, 1), ("flash_fwd_sm90_kernel<...>", 150, 300, 2),
               ("sm90_xmma_gemm", 500, 900, 3)], (0, 1_000_000))
    assert t.busy_s() == pytest.approx((200 + 400) / 1e9)
    assert t.window_s == pytest.approx(1e-3)
    assert t.kernel_time("flash_fwd_sm90_kernel") == (pytest.approx(150e-9), 1)
    gaps = dict(t.idle_gaps())
    assert gaps["launch latency"] == pytest.approx((100 + 200) / 1e9)
    assert gaps["portbench.call"] == pytest.approx((1_000_000 - 900) / 1e9)
    t.host.append(("train_step.optimizer", 90, 160, 1))
    t.launches = {1: 95, 2: 140, 3: 170}  # kernels 1 and 2 launched inside the span
    assert t.span_device_s("train_step.optimizer") == pytest.approx(250e-9)
    ops = dict(t.device_ops())
    assert ops["matmuls (cuBLAS)"] == pytest.approx(400e-9)
    assert kernel_group("gn_cluster_kernel") == "group_norm_silu (ours)"


def test_rooflines_per_launch_by_hand():
    c = census.Census()
    c.calls[("attention", (2, 64, 64, 2, 40, False))] = 3
    c.calls[("group_norm", (2, 64, 32, 32, True))] = 5
    v = census.Census()
    v.calls[("group_norm", (1, 256, 16, 16, False))] = 2
    rec = Record(work={"flops_per_image": 1.0, "parts": {"unet": (c, 10), "vae": (v, 1)}})
    a = attention_bound_s(2, 64, 64, 2, 40)
    # 40 launches recorded of the 30 the census expects: the ratio is per launch.
    rec.trace = trace([("flash_fwd_sm90_kernel", 0, 1000, 0)] * 40, (0, 10**6))
    assert reader("attn_roofline.sample").read(rec) == pytest.approx(100 * a / (1000e-9))
    g1, g2 = group_norm_bound_s(2, 64, 32, True), group_norm_bound_s(1, 256, 16, False)
    rec.trace = trace([("gn_cluster_kernel", 0, 500, 0)] * 7, (0, 10**6))
    want = (50 * g1 + 2 * g2) / 52 / 500e-9
    assert reader("gn_roofline.sample").read(rec) == pytest.approx(100 * want)
    rec.trace = None
    assert reader("attn_roofline.sample").read(rec) is None  # nothing to read: no number


def test_call_readers_by_hand():
    rec = Record(calls=[{"t0": 0.0, "t1": 2.0, "images": 4, "loop_s": 1.5, "traced": True},
                        {"t0": 2.0, "t1": 4.0, "images": 4, "loop_s": 1.7, "traced": True}],
                 work={"flops_per_image": 1e12, "parts": {}})
    assert reader("loop_s_per_image.sample").read(rec) == pytest.approx(3.2 / 8)
    assert reader("outside_loop_share.sample").read(rec) == pytest.approx(100 * (1 - 3.2 / 4))
    assert reader("mfu.sample").read(rec) is None  # no device trace: no device number
    rec.trace = trace([("k", 0, 10, 0)], (0, 4 * 10**9))
    assert reader("mfu.sample").read(rec) == pytest.approx(100 * 8e12 / (4 * PEAK_BF16))
    assert reader("device_idle.sample").read(rec) == pytest.approx(100 * (1 - 10 / 4e9))


def test_dpm_ladder_by_hand():
    cfg = harness.load_json(harness.ROOT / "configs" / "sd15.json")["pipeline"]["scheduler"]
    s = DPMSolverPP2M(cfg, 20)
    assert list(s.timesteps) == list(range(951, 0, -50))
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    acp = np.cumprod(1 - betas)
    assert s.sigmas[0] == pytest.approx(math.sqrt((1 - acp[951]) / acp[951]))
    assert s.sigmas[-1] == 0.0
    # A zero model output: each step scales x by sigma_t(next) / sigma_t(now)
    # plus alpha_next * (1 - e^-h) * x0; the last step returns x0 = x / alpha.
    x = torch.ones(1)
    out = s.run(x.clone(), lambda x, t: torch.zeros_like(x))
    ref = 1.0
    for i in range(19):
        h = s.lam[i + 1] - s.lam[i]
        x0 = ref / s.alpha[i]
        d = x0 if i == 0 else x0 + (x0 - prev) / (2 * (s.lam[i] - s.lam[i - 1]) / h)
        ref = s.sigma_t[i + 1] / s.sigma_t[i] * ref - s.alpha[i + 1] * np.expm1(-h) * d
        prev = x0
    assert float(out) == pytest.approx(ref / s.alpha[19], rel=1e-5)


def test_percentiles_arrivals_and_serve_readers_by_hand():
    from portbench.traffic.serve import arrivals, percentile

    # numpy's linear interpolation: 95th of 1..20 is 19.05; a missing request is +inf.
    assert percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    assert percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert percentile([1.0, math.inf], 95) == math.inf
    due = arrivals(1, 7.2, 40.0)
    assert len(due) == 288 and due[0] == 0.0 and np.all(np.diff(due) > 0)
    gaps = np.sort(np.diff(np.append(due, due[-1] + 1.0)))[:-1]
    # The gaps are the exponential quantiles at (j + 1/2) / n, one of them last (unused).
    want = -np.log1p(-(np.arange(288) + 0.5) / 288) / 7.2
    assert np.isin(np.round(gaps, 9), np.round(want, 9)).all()
    assert np.array_equal(arrivals(1, 7.2, 40.0), due)
    rec = Record(counters={"latency": [1.0, 2.0, 3.0, math.inf], "images": 18, "batches": 3,
                           "max_batch": 8})
    assert reader("request_p50_s.serve").read(rec) == pytest.approx(2.5)
    assert reader("batch_fill.serve").read(rec) == pytest.approx(75.0)
