"""Share of the profiled window (from the first request's due time to the
last result) in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "request_p95_s"
BETTER = "lower"
WORKLOADS = ["sd15-serve-mb8"]


def read(record):
    trace = record.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
