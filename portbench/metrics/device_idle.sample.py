"""Share of the profiled window (the harness's call spans) in which no
operation ran on the device."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-offline-b32"]


def read(record):
    trace = record.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
