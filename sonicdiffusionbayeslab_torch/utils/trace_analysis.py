"""Per-op breakdown of a ``torch.profiler`` Chrome trace.

Counterpart of ``sonicdiffusionbayeslab_tpu/utils/trace_analysis.py``,
which reads a ``jax.profiler`` trace.  ``utils.profiling.trace`` writes
one; this module turns it into the table that aims perf work: each
kernel's device time and launch count, grouped into buckets (the port's
kernels by symbol, the libraries' by their naming conventions), with the
achieved FLOP/s where the trace carries FLOP counts.

Usage::

    with profiling.trace("outputs/profile/run"):
        engine.sample(...)
    python -m sonicdiffusionbayeslab_torch.utils.trace_analysis outputs/profile/run [top]

The rows are the device kernels (category ``kernel``) that lie inside the
longest span whose name holds ``module_hint`` (a ``record_function``
label, say), or in the whole trace.  A trace without device kernels (a
CPU run) gives its CPU ops instead, each by self time (its duration less
its nested children's on the same thread).  The traces of a CUDA graph
replay hold its kernels (CUPTI records them), so a graphed loop counts.
CUPTI may drop records (ROADMAP.md section C): a count that must be exact
is checked against its census and retraced.
"""

from __future__ import annotations

import collections
import dataclasses
import gzip
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit): dense bf16 tensor-core
# peak; used only for the report's MFU column.
PEAK_FLOPS = float(989e12)

# The port's kernels by symbol (ops/csrc/*.cu), and cuBLASLt's int8 GEMMs
# (torch._int_mm on the H100: cutlass_80_tensorop_i16832gemm_s8_..._tn_align16).
SYMBOLS = {"attention": "flash_fwd_sm90_kernel", "group_norm": "gn_cluster_kernel",
           "attention_fp32": "flash_fwd_tf32x3_kernel"}
# The split GroupNorm pair of a seq-split map (group_norm_silu_split).
SPLIT_SYMBOLS = {"group_norm_partials": "gn_partials_kernel",
                 "group_norm_apply": "gn_apply_kernel"}
INT8_GEMM_SYMBOL = "gemm_s8"


@dataclasses.dataclass
class OpRow:
    name: str
    category: str
    self_ms: float
    count: int
    flops: float  # per call (the trace's "flops" argument, where recorded)
    bytes_accessed: float  # per call (torch.profiler records none: 0)
    long_name: str

    @property
    def tflops(self) -> float:
        if self.self_ms <= 0 or not self.flops:
            return 0.0
        return self.flops * self.count / (self.self_ms / 1e3) / 1e12

    @property
    def gbps(self) -> float:
        if self.self_ms <= 0 or not self.bytes_accessed:
            return 0.0
        return self.bytes_accessed * self.count / (self.self_ms / 1e3) / 1e9


def kernel_group(name: str, tome: bool = False) -> str:
    """The bucket of a device kernel (or CPU op), the JAX package's
    ``_classify``: ours by symbol, the libraries' by their kernel-name
    conventions; with ``tome``, Token Merging's sorts, gathers and
    scatters apart."""
    low = name.lower()
    if SYMBOLS["attention_fp32"] in name or SYMBOLS["attention"] in name:
        return "flash_attention (ours)"
    if SYMBOLS["group_norm"] in name:
        return "group_norm_silu (ours)"
    if any(sym in name for sym in SPLIT_SYMBOLS.values()):
        return "group_norm split (ours)"
    if INT8_GEMM_SYMBOL in low or "imma" in low:
        return "int8 GEMMs (cuBLASLt)"
    if any(w in low for w in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolutions (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "cublas", "xmma")) or low in (
            "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
        return "matmuls (cuBLAS)"
    if "layer_norm" in low:
        return "layer_norm"
    if tome and any(w in low for w in ("sort", "gather", "scatter", "indexselect",
                                         "index_select")):
        return "tome sorts, gathers, scatters"
    return "elementwise, reductions and copies"


def _latest_trace_file(log_dir: str | Path) -> Path:
    files = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in Path(log_dir).rglob(pat)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {log_dir}")
    return max(files, key=lambda p: p.stat().st_mtime)


def _load(path: Path) -> dict:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def _self_times(events: List[dict]) -> Tuple[Dict[str, float], Dict[str, int], Dict[str, dict]]:
    """Self time (us), count and first args of each name: a parent's
    duration less its nested children's, per (pid, tid)."""
    self_us: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    meta: Dict[str, dict] = {}
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Tuple[float, str]] = []
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]:
                stack.pop()
            if stack:
                self_us[stack[-1][1]] -= e["dur"]
            name = e["name"]
            stack.append((e["ts"] + e["dur"], name))
            self_us[name] += e["dur"]
            count[name] += 1
            meta.setdefault(name, e.get("args", {}) or {})
    return self_us, count, meta


def analyze(log_dir: str | Path, module_hint: str = "") -> Tuple[List[OpRow], float]:
    """(rows sorted by self time, descending; the window's ms): the
    newest trace under ``log_dir``, its device kernels inside the longest
    span named with ``module_hint`` (or the whole trace), else its CPU
    ops."""
    path = _latest_trace_file(log_dir)
    events = [e for e in _load(path)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if module_hint:
        spans = [e for e in events if e.get("cat") != "kernel" and module_hint in e["name"]]
        if not spans:
            raise RuntimeError(f"no span named with {module_hint!r} in {path}")
        win = max(spans, key=lambda e: e["dur"])
        w0, w1 = win["ts"], win["ts"] + win["dur"]
    ops = kernels or [e for e in events if e.get("cat") == "cpu_op"]
    if not ops:
        raise RuntimeError(f"no device kernel and no CPU op in {path}")
    if not module_hint:
        w0 = min(e["ts"] for e in ops)
        w1 = max(e["ts"] + e["dur"] for e in ops)
    ops = [e for e in ops if e["ts"] >= w0 and e["ts"] + e["dur"] <= w1]
    self_us, count, meta = _self_times(ops)
    rows = [OpRow(name=name, category=kernel_group(name), self_ms=us / 1e3, count=count[name],
                  flops=float(meta[name].get("flops", 0) or 0), bytes_accessed=0.0,
                  long_name=name[:200])
            for name, us in self_us.items()]
    rows.sort(key=lambda r: -r.self_ms)
    return rows, (w1 - w0) / 1e3


def rollup(rows: List[OpRow]) -> List[Tuple[str, float, int, float]]:
    """(bucket, self_ms, n_ops, achieved TFLOP/s) sorted by time desc."""
    ms = collections.Counter()
    n = collections.Counter()
    fl = collections.Counter()
    for r in rows:
        ms[r.category] += r.self_ms
        n[r.category] += r.count
        fl[r.category] += r.flops * r.count
    out = []
    for cat, t in ms.most_common():
        tf = fl[cat] / (t / 1e3) / 1e12 if t > 0 else 0.0
        out.append((cat, t, n[cat], tf))
    return out


def report(log_dir: str | Path, top: int = 20, module_hint: str = "") -> str:
    rows, window_ms = analyze(log_dir, module_hint)
    total = sum(r.self_ms for r in rows)
    lines = [f"window: {window_ms:.3f} ms ({total:.3f} ms accounted in op self-times)", "",
             "== category rollup ==",
             f"{'bucket':44s} {'ms':>9s} {'%':>6s} {'ops':>6s} {'TFLOP/s':>8s} {'MFU%':>5s}"]
    for cat, ms, n, tf in rollup(rows):
        lines.append(f"{cat:44s} {ms:9.3f} {100 * ms / total if total else 0.0:5.1f}% {n:6d} "
                     f"{tf:8.1f} {100 * tf * 1e12 / PEAK_FLOPS:5.1f}")
    lines += ["", "== top ops by self time ==",
              f"{'op':40s} {'ms':>9s} {'calls':>6s} {'TFLOP/s':>8s} {'GB/s':>7s}  bucket"]
    for r in rows[:top]:
        lines.append(f"{r.name[:40]:40s} {r.self_ms:9.3f} {r.count:6d} "
                     f"{r.tflops:8.1f} {r.gbps:7.1f}  {r.category}")
    return "\n".join(lines)


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 else "outputs/profile"
    print(report(d, top=int(sys.argv[2]) if len(sys.argv) > 2 else 20))
