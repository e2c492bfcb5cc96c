"""Image reading and PNG writing.

The port's counterparts of ``read_image`` and ``write_png`` in
``sonicdiffusionbayeslab_tpu/data/imageio.py``, without PIL:

* ``read_image`` decodes through the port's native library
  (``data/csrc/dataio.cpp``, built by ``data/_dataio.py``), by content, not
  by file name: a PNG (8-bit RGB or RGBA, not interlaced) with zlib, a
  JPEG with libjpeg where the library was built with it, else it raises
  naming libjpeg.  The resize and center crop are the reference's filter
  bank, so they give the same bytes.
* ``write_png`` uses numpy and the standard library alone (zlib + struct)
  and writes the bytes libpng writes with the reference's settings
  (``runtime/dataio.cpp::sdbl_encode_png``: 8-bit RGB, compression level
  3): libpng's filter choice per row, its zlib parameters and its
  8192-byte IDAT chunks.
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


# libpng's defaults for 8-bit RGB with compression level 3 (png.h 1.6:
# PNG_ALL_FILTERS, PNG_Z_DEFAULT_STRATEGY = Z_FILTERED, memLevel 8,
# PNG_ZBUF_SIZE = 8192 bytes of deflate output an IDAT chunk).
_PNG_LEVEL = 3
_PNG_ZBUF = 8192


def _filter_rows(image: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, 1 + 3W] uint8 scanlines, each row filtered as
    libpng's ``png_write_find_filter`` chooses: the filter among None, Sub,
    Up, Average and Paeth whose bytes, read as signed, have the least sum of
    absolute values, the first of them on a tie.  The row above the first
    is zeros; a single row leaves out Up, Average and Paeth, a single
    column Sub, Average and Paeth (``png_write_start_row``)."""
    h, w, c = image.shape
    x = image.reshape(h, w * c)
    up, left, corner = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    up[1:], left[:, c:], corner[1:, c:] = x[:-1], x[:, :-c], x[:-1, :-c]
    # The five candidates, each byte mod 256 (uint8 arithmetic wraps).
    tries = np.empty((5,) + x.shape, np.uint8)
    tries[0] = x
    np.subtract(x, left, out=tries[1])
    np.subtract(x, up, out=tries[2])
    np.subtract(x, (left >> 1) + (up >> 1) + (left & up & 1), out=tries[3])
    p = up.astype(np.int16) - corner
    q = left.astype(np.int16) - corner
    pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)
    paeth = corner.copy()
    np.copyto(paeth, up, where=pb <= pc)
    np.copyto(paeth, left, where=(pa <= pb) & (pa <= pc))
    np.subtract(x, paeth, out=tries[4])
    # |byte as int8|, where int8's abs(-128) is -128: 128 as uint8.
    cost = np.abs(tries.view(np.int8)).view(np.uint8).sum(axis=2, dtype=np.uint32)
    if h == 1:
        cost[[2, 3, 4]] = np.iinfo(np.uint32).max
    if w == 1:
        cost[[1, 3, 4]] = np.iinfo(np.uint32).max
    best = np.argmin(cost, axis=0)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = best
    rows[:, 1:] = tries[best, np.arange(h)]
    return rows


def _deflate(data: bytes) -> bytes:
    """The zlib stream libpng writes for an image of ``len(data)`` filtered
    bytes: a smaller window for images of at most 16 KiB
    (``png_deflate_claim``), and the header's window size lowered to the
    data's (``optimize_cmf``)."""
    size, wbits = len(data), 15
    if size <= 16384:
        half = 1 << (wbits - 1)
        while size + 262 <= half:
            half >>= 1
            wbits -= 1
    co = zlib.compressobj(_PNG_LEVEL, zlib.DEFLATED, wbits, 8, zlib.Z_FILTERED)
    z = bytearray(co.compress(data) + co.flush())
    cmf = z[0]
    if size <= 16384 and (cmf & 0x0F) == 8 and (cmf & 0xF0) <= 0x70:
        cinfo = cmf >> 4
        half = 1 << (cinfo + 7)
        if size <= half:
            half >>= 1
            cinfo -= 1
            while cinfo > 0 and size <= half:
                half >>= 1
                cinfo -= 1
            z[0] = cmf = (cmf & 0x0F) | (cinfo << 4)
            flg = z[1] & 0xE0
            z[1] = flg + 0x1F - ((cmf << 8) + flg) % 0x1F
    return bytes(z)


def encode_png_bytes(image: np.ndarray) -> bytes:
    """HWC uint8, or float in [0, 1], RGB image -> PNG bytes, the same bytes
    as the reference's native encoder."""
    if image.dtype != np.uint8:
        image = np.clip(np.asarray(image, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {image.shape}")
    h, w = image.shape[:2]
    z = _deflate(_filter_rows(np.ascontiguousarray(image)).tobytes())
    return (_PNG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + b"".join(_chunk(b"IDAT", z[i:i + _PNG_ZBUF]) for i in range(0, len(z), _PNG_ZBUF))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png_bytes(image))
