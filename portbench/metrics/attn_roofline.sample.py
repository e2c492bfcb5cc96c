"""The UNet attention kernel's share of its roofline: the mean least time
of one of its launches (the reference's census of the UNet at the call's
rows, ``peaks.attention_bound_s``) over the mean device time of one
``flash_fwd_sm90_kernel`` launch in the trace.  Taken per launch, so
records that CUPTI drops cancel."""

from portbench.peaks import attention_bound_s
from portbench.trace import SYMBOLS

LAYER = "kernels (ops/flash_attention.py, ops/groupnorm.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"
BETTER = "higher"
WORKLOADS = ["sd15-offline-b32"]


def read(record):
    if record.trace is None:
        return None
    bound = record.per_launch_bound_s("attention", ("unet",),
                                      lambda s: attention_bound_s(*s[:5]))
    seconds, launches = record.trace.kernel_time(SYMBOLS["attention"])
    if bound is None or not launches or seconds <= 0:
        return None
    return 100.0 * bound / (seconds / launches)
