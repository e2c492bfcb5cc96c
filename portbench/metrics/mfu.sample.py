"""The whole call's share of the bf16 peak: the reference's FLOPs for the
images the profiled calls completed (each prompt's text encode, the
CFG-doubled UNet rows of every step, the decode; counted on the meta
device) over the profiled calls' time on the harness's clock times
989 TFLOP/s."""

from portbench.peaks import PEAK_BF16

LAYER = "whole call"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "images_per_s"
BETTER = "higher"
WORKLOADS = ["sd15-offline-b32"]


def read(record):
    calls = record.traced_calls()
    if record.trace is None or record.work is None or not calls:
        return None
    seconds = calls[-1]["t1"] - calls[0]["t0"]
    images = sum(c["images"] for c in calls)
    return 100.0 * record.work["flops_per_image"] * images / (seconds * PEAK_BF16)
