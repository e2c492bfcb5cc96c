"""PNG writing with the standard library alone (zlib + struct).

The port's counterpart of ``write_png`` in
``sonicdiffusionbayeslab_tpu/data/imageio.py``, without PIL or a native
codec: 8-bit RGB, one filter-0 scanline per row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_bytes(image: np.ndarray) -> bytes:
    """HWC uint8, or float in [0, 1], RGB image -> PNG bytes."""
    if image.dtype != np.uint8:
        image = np.clip(np.asarray(image, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png_bytes(image))
