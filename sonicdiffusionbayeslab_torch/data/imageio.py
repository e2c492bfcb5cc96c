"""Image reading and PNG writing.

The port's counterparts of ``read_image`` and ``write_png`` in
``sonicdiffusionbayeslab_tpu/data/imageio.py``, without PIL:

* ``read_image`` decodes through the port's native library
  (``data/csrc/dataio.cpp``, built by ``data/_dataio.py``), by content, not
  by file name: a PNG (8-bit RGB or RGBA, not interlaced) with zlib, a
  JPEG with libjpeg where the library was built with it, else it raises
  naming libjpeg.  The resize and center crop are the reference's filter
  bank, so they give the same bytes.
* ``write_png`` uses the standard library alone (zlib + struct): 8-bit
  RGB, one filter-0 scanline per row.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xff\xd8\xff"
# Decode buffer: up to 64 MPixel (the reference's cap); pages that are never
# written are never touched.
_CAP = 64 * 1024 * 1024 * 3
_ERRORS = {-2: "corrupt data", -3: "not a file of this format", -4: "image over 64 MPixel",
           -5: "a PNG variant the decoder does not take (it takes 8-bit RGB or RGBA, "
               "not interlaced)"}


def _decode(raw: bytes, path) -> np.ndarray:
    from sonicdiffusionbayeslab_torch.data._dataio import library

    lib = library()
    if raw.startswith(_PNG):
        fn, kind = lib.sdbl_decode_png, "PNG"
    elif raw.startswith(_JPEG):
        if not lib.sdbl_has_jpeg():
            raise RuntimeError(
                f"{path}: a JPEG, but the image IO library was built without libjpeg "
                "(jpeglib.h not found at build time); install libjpeg's headers or convert "
                "the image to PNG")
        fn, kind = lib.sdbl_decode_jpeg, "JPEG"
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG (first bytes {raw[:8]!r})")
    out = np.empty(_CAP, np.uint8)
    w, h = ctypes.c_int32(), ctypes.c_int32()
    buf = np.frombuffer(raw, np.uint8)
    rc = fn(buf.ctypes.data, len(raw), out.ctypes.data, _CAP, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"{path}: {kind} decode failed ({_ERRORS.get(rc, f'error {rc}')})")
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """HWC uint8 RGB -> [size, size, 3] uint8: the short side resized to
    ``size`` with an antialiased triangle filter, then center-cropped."""
    from sonicdiffusionbayeslab_torch.data._dataio import library

    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or int(size) <= 0:
        raise ValueError(f"expected an [H, W, 3] image and a positive size, got {img.shape}, "
                         f"{size}")
    h, w = img.shape[:2]
    dst = np.empty((size, size, 3), np.uint8)
    rc = library().sdbl_resize_center_crop(img.ctypes.data, w, h, size, dst.ctypes.data)
    if rc != 0:
        raise ValueError(f"resize of a {w}x{h} image to {size} failed (error {rc})")
    return dst


def read_image(path: str | Path, image_size: Optional[int] = None) -> np.ndarray:
    """HWC float32 RGB in [0, 1]; resized and center-cropped to
    [image_size, image_size] when ``image_size`` is given and differs."""
    img = _decode(Path(path).read_bytes(), path)
    if image_size is not None and img.shape[:2] != (image_size, image_size):
        img = resize_center_crop(img, int(image_size))
    return img.astype(np.float32) / 255.0


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
