"""Seconds of the denoising loop an image: the sum of the program's
``execution_time`` (``models/sampler.py``, the device synchronised at both
ends of the loop) over the window's calls, over their images."""

LAYER = "engine loop (models/sampler.py)"
UNIT = "s/image"
SOURCE = "program_span"
MOVES = "images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-offline-b32"]


def read(record):
    calls = record.calls
    images = sum(c["images"] for c in calls)
    if not images or any(c["loop_s"] < 0 for c in calls):
        return None
    return sum(c["loop_s"] for c in calls) / images
