"""The device memory the window's steps held at their peak:
``torch.cuda.max_memory_allocated`` after a reset at the window's start,
in GB (1e9 bytes)."""

LAYER = "device"
UNIT = "GB"
SOURCE = "program_counter"
MOVES = "train_images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-lora-b8"]


def read(record):
    peak = record.counters.get("window_peak_bytes", 0)
    return peak / 1e9 if peak > 0 else None
