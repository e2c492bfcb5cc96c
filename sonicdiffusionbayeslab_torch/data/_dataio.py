"""Build and load the port's image IO library (``data/csrc/dataio.cpp``).

``g++`` compiles it at first use into ``build/dataio/`` at the repository
root, as ``ops/_build.py`` does for the CUDA kernels: the file name carries
a hash of the source and the flags, so an edited source rebuilds, and a
build is written under a temporary name and renamed, so processes that
build at once do not read a half-written library.  zlib is always needed;
libjpeg only where its header is found, and then the JPEG decoder is
compiled in (``SDBL_HAVE_JPEG``).  A failed build raises with g++'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "dataio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dataio"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def _has_header(name: str) -> bool:
    """Whether g++ finds ``<name>`` on its include path."""
    r = subprocess.run(["g++", "-E", "-x", "c++", "-"], input=f"#include <{name}>\n",
                       capture_output=True, text=True)
    return r.returncode == 0


def _flags() -> tuple[list, list]:
    """(compile flags, libraries to link)."""
    if _has_header("jpeglib.h"):
        return FLAGS + ["-DSDBL_HAVE_JPEG"], ["-ljpeg", "-lz"]
    return FLAGS, ["-lz"]


def build_library() -> Path:
    """Path of the library, built first if it is not there yet."""
    cflags, libs = _flags()
    h = hashlib.sha256(" ".join(cflags + ["|"] + libs).encode())
    h.update(SOURCE.read_bytes())
    path = BUILD_DIR / f"libsdbl_dataio_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.name}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *cflags, str(SOURCE), "-o", str(tmp), *libs],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"image IO library build failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            u8p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            i32p = ctypes.POINTER(ctypes.c_int32)
            for fn in (lib.sdbl_decode_jpeg, lib.sdbl_decode_png):
                fn.argtypes = [u8p, i64, u8p, i64, i32p, i32p]
                fn.restype = ctypes.c_int
            lib.sdbl_resize_center_crop.argtypes = [u8p, i32, i32, i32, u8p]
            lib.sdbl_resize_center_crop.restype = ctypes.c_int
            lib.sdbl_has_jpeg.restype = ctypes.c_int
            lib.sdbl_dataio_version.restype = ctypes.c_int
            if lib.sdbl_dataio_version() != 1:
                raise RuntimeError("image IO library: unexpected version")
            _lib = lib
    return _lib
