"""Reading a ``torch.profiler`` trace of the measured window: the device's
kernels, the host's spans, busy and idle time, and the breakdown the
result line carries.

The events come from the profiler's raw Kineto list (``chip_smoke.py::
device_event_names`` reads the same), which costs no Python object tree.
``kernel_group`` is a copy of ``utils/trace_analysis.py::kernel_group``
(the port's kernels by symbol, the libraries' by their naming), so that a
change of the program does not move the buckets.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

# The port's kernels by symbol (ops/csrc/*.cu).
SYMBOLS = {"attention": "flash_fwd_sm90_kernel", "group_norm": "gn_cluster_kernel",
           "attention_fp32": "flash_fwd_tf32x3_kernel"}
SPLIT_SYMBOLS = ("gn_partials_kernel", "gn_apply_kernel")
INT8_GEMM_SYMBOL = "gemm_s8"
# A device gap shorter than this is a launch's own latency, not idle time
# that a host stall causes; it still counts as idle.
GAP_NAMED_MIN_NS = 20_000
HOST_LOOKBACK = 512


def kernel_group(name: str) -> str:
    low = name.lower()
    if SYMBOLS["attention_fp32"] in name or SYMBOLS["attention"] in name:
        return "flash_attention (ours)"
    if SYMBOLS["group_norm"] in name:
        return "group_norm_silu (ours)"
    if any(sym in name for sym in SPLIT_SYMBOLS):
        return "group_norm split (ours)"
    if INT8_GEMM_SYMBOL in low or "imma" in low:
        return "int8 GEMMs (cuBLASLt)"
    if any(w in low for w in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolutions (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "cublas", "xmma")):
        return "matmuls (cuBLAS)"
    if "layer_norm" in low:
        return "layer_norm"
    return "elementwise, reductions and copies"


@dataclasses.dataclass
class Trace:
    """Kernels and host events of one traced window, times in ns on the
    profiler's clock; ``window`` is the (start, end) of the harness's
    spans named ``span``."""

    kernels: List[Tuple[str, int, int, int]]  # (name, start, end, correlation id)
    host: List[Tuple[str, int, int, int]]  # (name, start, end, thread)
    window: Tuple[int, int]
    launches: Dict[int, int] = dataclasses.field(default_factory=dict)  # id -> host ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the kernels' intervals inside the window, sorted."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in self.kernels if e > w0 and s < w1)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def kernel_time(self, symbol: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose names hold ``symbol``."""
        ns = [e - s for name, s, e, _ in self.kernels if symbol in name]
        return sum(ns) / 1e9, len(ns)

    def span_device_s(self, span: str) -> float:
        """Device seconds of the kernels launched while the host was inside
        a span named ``span`` (launch and kernel matched by the profiler's
        correlation id)."""
        spans = sorted((s, e) for name, s, e, _ in self.host if name == span)
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.kernels:
            at = self.launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at < spans[i][1]:
                total += e - s
        return total / 1e9

    def top_kernels(self, top: int = 12) -> List[List]:
        """[name, seconds, launches] of the kernels that took most time."""
        ns: Dict[str, int] = collections.Counter()
        n: Dict[str, int] = collections.Counter()
        for name, s, e, _ in self.kernels:
            ns[name] += e - s
            n[name] += 1
        return [[k[:80], v / 1e9, n[k]] for k, v in ns.most_common(top)]

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = collections.Counter()
        for name, s, e, _ in self.kernels:
            by[kernel_group(name)] += e - s
        return [[k, v / 1e9] for k, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The idle time between kernels inside the window, by the innermost
        host event running at each gap's start (gaps under
        GAP_NAMED_MIN_NS go to "launch latency")."""
        busy = self.intervals()
        w0, w1 = self.window
        edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: Dict[str, int] = collections.Counter()
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            if g1 - g0 < GAP_NAMED_MIN_NS:
                by["launch latency"] += g1 - g0
                continue
            # The latest-starting host event that still runs at g0 is the
            # innermost; look back over a bounded stretch of events.
            name = "host outside any event"
            i = bisect.bisect_right(starts, g0)
            for h in reversed(host[max(0, i - HOST_LOOKBACK):i]):
                if h[2] > g0:
                    name = h[0]
                    break
            by[name] += g1 - g0
        return [[k, v / 1e9] for k, v in by.most_common(top)]


def read(prof, span: str) -> Optional[Trace]:
    """The ``Trace`` of a finished ``torch.profiler.profile`` whose window
    is the union of its host spans named ``span``; None where it recorded
    no device kernel."""
    from torch.autograd import DeviceType

    kernels, host, spans, launches = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():  # a host span mirrored on the GPU's row
                kernels.append((e.name(), s, s + d, e.correlation_id()))
        else:
            host.append((e.name(), s, s + d, e.start_thread_id()))
            if e.correlation_id():
                launches[e.correlation_id()] = s
            if e.name() == span:
                spans.append((s, s + d))
    if not kernels or not spans:
        return None
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    return Trace(kernels=kernels, host=host, window=window, launches=launches)
