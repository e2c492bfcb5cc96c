"""Profiling and tracing.

Counterpart of ``sonicdiffusionbayeslab_tpu/utils/profiling.py``:

* :func:`sync`: an honest device synchronisation, then a one-element host
  read of the result's first tensor;
* :func:`time_it`: the decorator returning ``(result, seconds)`` with the
  device synchronised, so asynchronous CUDA work is counted;
* :func:`trace`: a context manager around ``torch.profiler`` writing a
  Chrome trace (``*.pt.trace.json``) into a directory, which
  ``utils/trace_analysis.py`` reads;
* :func:`flops_estimate`: the floating-point operations of one call, from
  ``torch.utils.flop_counter.FlopCounterMode`` plus the port's kernels.

The JAX package's ``flops_estimate`` is XLA's cost analysis of the
compiled function, which also counts elementwise work (activations,
normalisation, the CFG combine); FlopCounterMode counts matmuls,
convolutions and attention only.  The two numbers are therefore not equal.
The hand-written kernels are ``ctypes`` launches that FlopCounterMode does
not see, so their wrappers add their own counts (``ops/_build.py::
add_flops``): 4·B·H·N·M·D for attention (its two products; on the CPU the
plain version's einsums are counted by FlopCounterMode instead) and ~6
operations an element for GroupNorm, 10 with SiLU (on both paths).
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import time
from pathlib import Path

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Wait for the device work behind ``x`` (a tensor or a structure of
    them): ``torch.cuda.synchronize`` where CUDA is in use, then one
    element of the first tensor read on the host."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    first = next(_tensors(x), None)
    if first is not None and first.numel():
        first.reshape(-1)[0].item()
    return x


def time_it(fn):
    """``fn`` returning ``(result, elapsed seconds)``, the device synced."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = sync(fn(*args, **kwargs))
        return result, time.perf_counter() - start

    return wrapper


@contextlib.contextmanager
def trace(log_dir: str | Path = "outputs/profile"):
    """``with trace("outputs/profile") as d: run()`` -> a Chrome trace of
    the CPU ops and, where CUDA is in use, the device kernels, written as
    ``<host>_<pid>.<ms>.pt.trace.json`` into ``log_dir`` when the block
    ends."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(str(log_dir / name))


def flops_estimate(fn, *args) -> dict:
    """``{"flops": n}``: the floating-point operations of ``fn(*args)``, run
    once (matmuls, convolutions and attention from FlopCounterMode, plus
    the port's kernels' own counts)."""
    from torch.utils.flop_counter import FlopCounterMode

    from sonicdiffusionbayeslab_torch.ops import _build

    sink = [0]
    _build.flop_sinks.append(sink)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
    finally:
        _build.flop_sinks.remove(sink)
    return {"flops": int(counter.get_total_flops()) + sink[0]}
