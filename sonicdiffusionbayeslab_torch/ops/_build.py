"""Build and load the port's hand-written CUDA kernels.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, from the repository's sources only, into
``build/torch_kernels/`` at the repository root; the library's file name
carries a hash of the sources, the headers they include (``*.cuh``) and
the compile and link flags, so an edited source, header or flag rebuilds.
A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --split-compile=0: a source's device code is optimised on all cores, so
# the template instantiations of one source (flash_attention.cu has 20) are
# not compiled one after another.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--split-compile=0",
]
LINK_FLAGS = ["-ldl"]  # dlopen/dlsym of the driver's cuTensorMapEncodeTiled

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failures = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def digest(csrc: Path = CSRC) -> str:
    """Hash of every source and header under ``csrc`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ["|"] + LINK_FLAGS).encode())
    for s in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Path of the kernel library, built first if it is not there yet."""
    sources = sorted(CSRC.glob("*.cu"))
    key = digest()
    lib_path = BUILD_DIR / f"libsdbl_torch_kernels_{key}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}_{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)])
    tmp = BUILD_DIR / f"lib_{tag}.so.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), *LINK_FLAGS, "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.sdbl_flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i] + [i64] * 12 + [f, p]
    lib.sdbl_flash_attention_fwd.restype = i
    lib.sdbl_flash_attention_sm90.argtypes = [p, p, p, p, i, i, i, i, i] + [i64] * 12 + [f, i, p]
    lib.sdbl_flash_attention_sm90.restype = i
    lib.sdbl_groupnorm_fwd.argtypes = [p, p, p, p] + [i] * 10 + [f, i, i, p]
    lib.sdbl_groupnorm_fwd.restype = i
    lib.sdbl_groupnorm_active_clusters.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.sdbl_groupnorm_active_clusters.restype = i


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned an error: a cudaError_t, or
    minus a CUresult where a TMA tensor map could not be encoded."""
    if err < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch on ``wrapper.launches``, under a lock: the training
    loop's prep thread launches kernels beside the main thread."""
    with _count_lock:
        wrapper.launches += 1


# The open FLOP counts (``utils/profiling.py::flops_estimate``), each a
# one-element list: torch's FlopCounterMode cannot see a ctypes launch.
flop_sinks: list = []


def add_flops(n: int) -> None:
    """Add ``n`` operations to every open FLOP count."""
    if flop_sinks:
        with _count_lock:
            for sink in flop_sinks:
                sink[0] += int(n)
