"""The ``SDBL_*`` environment defaults of the port, and the only place in
the port that reads them.

Counterparts of the JAX package's environment reads, with its precedence
and error words: an explicit argument beats the variable, and the
variable beats the default.  The entry points call these readers
(``engine.sample``, the engines' construction, ``ops/quant.py::
get_quant_mode``, ``ops/attention.py::get_attention_backend``,
``parallel/distributed.initialize``, ``metrics.ImageRewardMetric``,
``quality_frontier.py``'s arguments); no forward reads the environment.

* ``SDBL_QUANT``: the UNet's int8 mode (``int8``, ``int8_conv``,
  ``int8_conv_only``), read when an engine is built.
* ``SDBL_TOME_RATIO``: Token Merging's ratio for a ``sample`` call
  without ``tome``.
* ``SDBL_UNET_MICROBATCH``: the UNet chunks of a ``sample`` call without
  ``microbatch``.
* ``SDBL_CFG_PREFIX``: the CFG shared prefix for a ``sample`` call without
  ``cfg_prefix`` (any non-empty value turns it on, as in the JAX package).
* ``SDBL_FUSED_QKV``: ``1`` builds fused q/k/v projections
  (``to_qkv``/``to_kv``) into an engine built without ``fused_qkv``.
* ``SDBL_CHECK_NANS``: any non-empty value checks a ``sample`` call's
  final latents for non-finite values.
* ``SDBL_ATTENTION``: the attention backend where none was set
  (``set_attention_backend``); a name outside ``xla``, ``pallas`` and
  ``tiered`` raises there, where the JAX package would send it to XLA.
* ``SDBL_COORDINATOR``: ``initialize``'s coordinator where none is given.
* ``SDBL_IMAGE_REWARD_CKPT``: the ImageReward checkpoint where none is
  given.
* ``SDBL_SD15_SNAPSHOT``, ``SDBL_CLIP_SNAPSHOT``, ``SDBL_SD3_SNAPSHOT``:
  ``quality_frontier.py``'s ``--sd15``, ``--clip`` and ``--sd3``.

The JAX package's TPU-only variables (XLA layout, scheduling and cache
hints, and the Pallas kernels' toggles) have no counterpart; README.md
lists them.
"""

from __future__ import annotations

import os
from typing import Optional

QUANT_MODES = ("int8", "int8_conv", "int8_conv_only")


def _raw(name: str) -> Optional[str]:
    return os.environ.get(name)


def quant_mode() -> Optional[str]:
    """``SDBL_QUANT``, lower-cased, or None where unset or empty."""
    env = (_raw("SDBL_QUANT") or "").strip().lower() or None
    if env is not None and env not in QUANT_MODES:
        raise ValueError(f"unknown SDBL_QUANT {env!r} (int8 | int8_conv | int8_conv_only | unset)")
    return env


def tome_ratio(tome=None):
    """``tome`` where given, else ``SDBL_TOME_RATIO`` as a float, else None."""
    if tome is None and _raw("SDBL_TOME_RATIO"):
        return float(_raw("SDBL_TOME_RATIO"))
    return tome


def unet_microbatch(microbatch: Optional[int] = None) -> int:
    """``microbatch`` where given, else ``SDBL_UNET_MICROBATCH``, else 0."""
    if microbatch is None:
        microbatch = int(_raw("SDBL_UNET_MICROBATCH") or "0")
    return int(microbatch)


def cfg_prefix(flag: Optional[bool] = None) -> bool:
    """``flag`` where given, else whether ``SDBL_CFG_PREFIX`` is non-empty."""
    return bool(_raw("SDBL_CFG_PREFIX")) if flag is None else bool(flag)


def fused_qkv(flag: Optional[bool] = None) -> bool:
    """``flag`` where given, else whether ``SDBL_FUSED_QKV`` is ``1``."""
    return _raw("SDBL_FUSED_QKV") == "1" if flag is None else bool(flag)


def check_nans(flag: Optional[bool] = None) -> bool:
    """``flag`` where given, else whether ``SDBL_CHECK_NANS`` is non-empty."""
    return bool(_raw("SDBL_CHECK_NANS")) if flag is None else bool(flag)


def attention_backend() -> Optional[str]:
    """``SDBL_ATTENTION``, lower-cased, or None where unset or empty."""
    return (_raw("SDBL_ATTENTION") or "").strip().lower() or None


def coordinator(address: Optional[str] = None) -> Optional[str]:
    """``address`` where given, else ``SDBL_COORDINATOR``."""
    return address or _raw("SDBL_COORDINATOR")


def image_reward_checkpoint() -> Optional[str]:
    """``SDBL_IMAGE_REWARD_CKPT``, or None."""
    return _raw("SDBL_IMAGE_REWARD_CKPT") or None


def snapshot(family: str) -> Optional[str]:
    """``SDBL_<FAMILY>_SNAPSHOT`` (``sd15``, ``clip``, ``sd3``), or None."""
    return _raw(f"SDBL_{family.upper()}_SNAPSHOT")
