"""The GroupNorm(+SiLU) kernel's share of its roofline: the mean least
time of one of its launches (the reference's census of the UNet call and
the VAE decode, ``peaks.group_norm_bound_s``) over the mean device time of
one ``gn_cluster_kernel`` launch in the trace; per launch, as
``attn_roofline.sample``."""

from portbench.peaks import group_norm_bound_s
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
    bound = record.per_launch_bound_s(
        "group_norm", ("unet", "vae"), lambda s: group_norm_bound_s(s[0], s[1], s[2], s[4]))
    seconds, launches = record.trace.kernel_time(SYMBOLS["group_norm"])
    if bound is None or not launches or seconds <= 0:
        return None
    return 100.0 * bound / (seconds / launches)
