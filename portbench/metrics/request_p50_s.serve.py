"""The median latency over every request due in the window, each timed
from its due time to its result (a missing request counts as infinite)."""

from portbench.traffic.serve import percentile

LAYER = "service (serving/batcher.py)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "request_p95_s"
BETTER = "lower"
WORKLOADS = ["sd15-serve-mb8"]


def read(record):
    latency = record.counters.get("latency")
    return percentile(latency, 50) if latency else None
