"""The whole train step's share of the bf16 peak: the reference step's
FLOPs (the UNet's forward with the adapters merged and the backward to
them, counted on the meta device) times the steps of the traced run's
untraced stretch (the profiler slows the eager host path), over that
stretch's time (device synchronised at both ends) times 989 TFLOP/s."""

from portbench.peaks import PEAK_BF16

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_images_per_s"
BETTER = "higher"
WORKLOADS = ["sd15-lora-b8"]


def read(record):
    steps, seconds = record.counters.get("untraced_steps"), record.counters.get("untraced_s")
    if record.trace is None or record.work is None or not steps or not seconds:
        return None
    return 100.0 * record.work["flops_per_step"] * steps / (seconds * PEAK_BF16)
