"""Share of the summed time of the trainer's ``train_step.optimizer`` spans
(the global norm, the clipped AdamW update and the EMA) in which no
operation ran on the device."""

from portbench.spans import idle_share

LAYER = "trainer (training/trainer.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_images_per_s"
BETTER = "lower"
WORKLOADS = ["sd15-lora-b8"]


def read(record):
    return idle_share(record.trace, "train_step.optimizer")
