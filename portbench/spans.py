"""What the per-layer readers take from the program's own spans
(``utils/profiling.py::span`` in the port): the share of a span's time in
which the device ran nothing.  It reads the spans' host times and the
kernels' device times only, not which call launched a kernel."""

from __future__ import annotations

import bisect
from typing import Optional


def idle_share(trace, name: str) -> Optional[float]:
    """Share (%) of the summed time of the spans ``name`` in which no
    operation ran on the device (the union of the window's kernels); None
    where the trace holds no such span, as a program without it gives."""
    if trace is None:
        return None
    spans = [(s, e) for n, s, e, _ in trace.host if n == name and e > s]
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    busy = trace.intervals()
    ends = [e for _, e in busy]
    covered = 0
    for s, e in spans:
        i = bisect.bisect_right(ends, s)  # the first interval that ends after s
        while i < len(busy) and busy[i][0] < e:
            covered += min(e, busy[i][1]) - max(s, busy[i][0])
            i += 1
    return 100.0 * (1.0 - covered / total)
