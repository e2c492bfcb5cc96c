"""What a run hands to the per-layer metric readers
(``portbench/metrics/<name>.py``, each a ``read(record) -> float | None``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench.trace import Trace


@dataclasses.dataclass
class Record:
    """``calls``: each timed call of the window, {"t0", "t1" (host clock,
    s), "images", "loop_s" (the program's ``execution_time``),
    "traced" (inside the profiled stretch)}; ``window_s``: the window's
    length on the host clock; ``trace``: the profiled stretch (or None);
    ``work``: the reference's census of the cell ({"flops_per_image",
    "parts": {network: (Census, launches a call)}}) where the run was
    traced; ``counters``: the harness's own counts."""

    calls: List[Dict] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    trace: Optional[Trace] = None
    work: Optional[Dict] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def traced_calls(self) -> List[Dict]:
        return [c for c in self.calls if c.get("traced")]

    def per_launch_bound_s(self, kind: str, networks: Tuple[str, ...], bound) -> Optional[float]:
        """The mean least time of one launch of ``kind`` over the calls the
        ``networks`` make in one timed call (each network's census times
        its launches a call), ``bound(shape)`` giving one launch's."""
        if self.work is None:
            return None
        total = launches = 0.0
        for net in networks:
            census, per_call = self.work["parts"][net]
            for (k, shape), n in census.calls.items():
                if k == kind:
                    total += per_call * n * bound(shape)
                    launches += per_call * n
        return total / launches if launches else None
