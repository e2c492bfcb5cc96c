"""The port's profiling tools on the CPU: ``utils/profiling.py`` (sync,
time_it, trace, flops_estimate) and ``utils/trace_analysis.py`` (a
synthetic Chrome trace with device kernels, a real CPU torch.profiler
trace of a tiny UNet forward, the rollup against the JAX package's)."""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_parity import randn, t
from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention
from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_silu
from sonicdiffusionbayeslab_torch.utils import profiling
from sonicdiffusionbayeslab_torch.utils import trace_analysis as TA

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "args": {"stream": stream}}


def _synthetic_trace():
    """Device kernels (two of each of ours, a GEMM, a convolution, a copy)
    and a ``loop`` annotation around all but the first two; CPU ops whose
    time the device kernels' presence excludes."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
           "dur": 500},
          _kernel("void flash_fwd_sm90_kernel<128>(Params)", 10, 30),
          _kernel("elementwise_kernel", 50, 5),
          {"ph": "X", "cat": "user_annotation", "name": "loop", "pid": 1, "tid": 1, "ts": 100,
           "dur": 300},
          _kernel("void flash_fwd_sm90_kernel<128>(Params)", 110, 40),
          _kernel("gn_cluster_kernel<float>", 160, 20),
          _kernel("gn_cluster_kernel<float>", 190, 20),
          _kernel("sm90_xmma_gemm_bf16bf16_bf16f32", 220, 60),
          _kernel("cudnn::fprop_implicit_gemm", 290, 50),
          _kernel("flash_fwd_tf32x3_kernel<64>", 350, 10)]
    return {"traceEvents": ev}


def test_analyze_reads_the_newest_trace_and_its_window(tmp_path):
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "a.pt.trace.json").write_text(json.dumps({"traceEvents": []}))
    newer = tmp_path / "run" / "h_1.2.pt.trace.json.gz"
    newer.parent.mkdir()
    with gzip.open(newer, "wt") as f:
        json.dump(_synthetic_trace(), f)
    os.utime(tmp_path / "old" / "a.pt.trace.json", (1, 1))
    rows, window = TA.analyze(tmp_path)
    assert window == pytest.approx(0.350)  # first kernel's start to the last one's end
    by = {c: (ms, n) for c, ms, n, _ in TA.rollup(rows)}
    assert by["flash_attention (ours)"] == (pytest.approx(0.080), 3)
    assert by["group_norm_silu (ours)"] == (pytest.approx(0.040), 2)
    assert by["matmuls (cuBLAS)"] == (pytest.approx(0.060), 1)
    assert by["convolutions (cuDNN)"] == (pytest.approx(0.050), 1)
    assert by["elementwise, reductions and copies"] == (pytest.approx(0.005), 1)
    assert "aten::mm" not in {r.name for r in rows}  # device kernels exclude CPU ops
    rows, window = TA.analyze(tmp_path, module_hint="loop")
    assert window == pytest.approx(0.300)
    assert sum(r.count for r in rows) == 6 and rows[0].self_ms == pytest.approx(0.060)
    with pytest.raises(RuntimeError, match="no span"):
        TA.analyze(tmp_path, module_hint="absent")
    with pytest.raises(FileNotFoundError):
        TA.analyze(tmp_path / "old" / "none")


def test_report_and_main_count_kernels_by_group(tmp_path):
    (tmp_path / "x.pt.trace.json").write_text(json.dumps(_synthetic_trace()))
    text = TA.report(tmp_path, top=3)
    assert "== category rollup ==" in text and "== top ops by self time ==" in text
    r = subprocess.run([sys.executable, "-m", "sonicdiffusionbayeslab_torch.utils.trace_analysis",
                        str(tmp_path)], capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("flash_attention (ours)"))
    assert line.split()[-3] == "3"  # the ops column
    assert TA.PEAK_FLOPS == 989e12


def test_rollup_equals_the_jax_packages_on_the_same_rows():
    from sonicdiffusionbayeslab_tpu.utils import trace_analysis as JTA

    fields = [("a", "x", 3.5, 2, 1e9, 0.0, "a"), ("b", "y", 1.25, 5, 0.0, 0.0, "b"),
              ("c", "x", 0.75, 1, 4e6, 0.0, "c"), ("d", "z", 0.0, 1, 1e3, 0.0, "d")]
    got = TA.rollup([TA.OpRow(*f) for f in fields])
    want = JTA.rollup([JTA.OpRow(*f) for f in fields])
    assert got == want and [g[0] for g in got] == ["x", "y", "z"]
    for f in fields:
        assert (TA.OpRow(*f).tflops, TA.OpRow(*f).gbps) == (JTA.OpRow(*f).tflops,
                                                          JTA.OpRow(*f).gbps)


def test_trace_of_a_tiny_unet_forward_on_the_cpu(tmp_path):
    """profiling.trace writes a Chrome trace; analyze gives its CPU ops by
    self time (no device kernels here), whose sum is the window's work,
    and the ``record_function`` span narrows the window."""
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig

    unet = UNet2DCondition(UNetConfig.tiny()).eval()
    x, ctx = t(randn((1, 8, 8, 4), 0)), t(randn((1, 77, 32), 1))
    with torch.no_grad(), profiling.trace(tmp_path / "prof") as d:
        with torch.profiler.record_function("unet_forward"):
            unet(x, torch.tensor([10.0]), ctx)
    assert d == tmp_path / "prof" and len(list(d.glob("*.pt.trace.json"))) == 1
    rows, window = TA.analyze(d)
    names = {r.name for r in rows}
    assert {"aten::conv2d", "aten::linear"} <= names
    assert all(r.self_ms >= 0 for r in rows)
    assert 0 < sum(r.self_ms for r in rows) <= window + 1e-6
    cats = {r.category for r in rows}
    assert "convolutions (cuDNN)" in cats
    hinted, w2 = TA.analyze(d, module_hint="unet_forward")
    assert {r.name for r in hinted} <= names
    assert 0 < sum(r.self_ms for r in hinted) <= w2 + 1e-6


def test_flops_estimate_is_exact_for_a_matmul_and_the_kernel_wrappers():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    assert profiling.flops_estimate(torch.matmul, a, b) == {"flops": 2 * 3 * 5 * 7}
    B, N, M, H, D = 2, 16, 8, 3, 8
    q, k, v = t(randn((B, N, H, D), 0)), t(randn((B, M, H, D), 1)), t(randn((B, M, H, D), 2))
    assert profiling.flops_estimate(flash_attention, q, k, v) == {"flops": 4 * B * H * N * M * D}
    x, w, bias = t(randn((2, 16, 8), 3)), torch.ones(8), torch.zeros(8)
    assert profiling.flops_estimate(group_norm_silu, x, w, bias, 4) == {"flops": 10 * x.numel()}
    assert profiling.flops_estimate(lambda: group_norm_silu(x, w, bias, 4, silu=False)) == {
        "flops": 6 * x.numel()}
    assert profiling.flops_estimate(lambda: None) == {"flops": 0}  # the sinks closed


def test_sync_and_time_it():
    out, secs = profiling.time_it(lambda n: {"y": torch.arange(n) * 2})(4)
    assert out["y"].tolist() == [0, 2, 4, 6] and secs >= 0
    assert profiling.sync([torch.zeros(0), 3])[1] == 3  # an empty first tensor reads nothing
    assert profiling.sync(torch.ones(2)).tolist() == [1.0, 1.0]
