"""Share of the window's whole-call time spent outside the denoising loop:
1 - the sum of the program's ``execution_time`` over the sum of the calls'
times on the harness's clock (tokenize, encode, decode, uint8 round, copy
to the host, and the pipeline's own work)."""

LAYER = "pipeline (models/pipelines.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-offline-b32"]


def read(record):
    calls = record.calls
    whole = sum(c["t1"] - c["t0"] for c in calls)
    if whole <= 0 or any(c["loop_s"] < 0 for c in calls):
        return None
    return 100.0 * (1.0 - sum(c["loop_s"] for c in calls) / whole)
