"""Device milliseconds a step of the loss and its gradient: the kernels
launched inside the trainer's span ``train_step.loss_and_grad``
(``training/trainer.py``), over the profiled steps."""

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
    seconds = record.trace.span_device_s("train_step.loss_and_grad")
    return 1e3 * seconds / steps if seconds > 0 else None
