"""Device milliseconds a step of the optimizer: the kernels launched
inside the trainer's span ``train_step.optimizer`` (the global norm, the
clipped AdamW update and the EMA), over the profiled steps."""

LAYER = "trainer (training/trainer.py)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "train_images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-lora-b8"]


def read(record):
    steps = len(record.traced_calls())
    if record.trace is None or not steps:
        return None
    seconds = record.trace.span_device_s("train_step.optimizer")
    return 1e3 * seconds / steps if seconds > 0 else None
