"""CUDA graphs around a module call, for the denoising loop.

Eager PyTorch spends more host time on one SD-1.5 UNet forward at batch 4
in bf16 than an NVIDIA H100 needs to run it, so an eager loop waits on the
host.  ``GraphedCall`` captures the call for one input signature (shapes,
dtypes, devices) and then replays it: the inputs are copied into the
graph's static buffers, the graph is launched, and a copy of its output
(a tensor or a tuple of tensors) is returned, so that outputs of two
replays never alias.  The first call of a signature runs it twice eagerly
(cuDNN and cuBLAS pick their algorithms, the kernels set their attributes)
and captures it; that is set-up, like a compile.

A ``GraphedCall`` keeps only its last signature's graph: a call with
another signature drops the graph before it captures the new one, so its
private memory pool (the call's activations) goes back to the caching
allocator.  A caller that alternates between shapes pays a capture at each
change.

``GraphedVariants`` keeps one ``GraphedCall`` per call variant, a variant
being the keyword arguments that are not tensors.  The sampler's plain
UNet call is one variant; a DeepCache run adds two more (the full call
that returns the trunk's features and the shallow call that takes them),
so a DeepCache run holds two graphs at once (three in an engine that
also ran plain calls), each with its own pool of activations.  At SD-1.5 bf16 512x512, UNet batch 4, the plain graph keeps
0.35 GB reserved and DeepCache's full and shallow graphs 0.58 GB together
(NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py`` phase 7, PERF.md
section 2).
"""

from __future__ import annotations

import functools

import torch


class GraphedCall:
    """``fn(*tensors) -> tensor or tuple of tensors``, replayed from a CUDA
    graph of the last input signature it was called with (an argument may
    be None, which is part of the signature).  ``captures`` counts the
    captures."""

    WARMUP = 2

    def __init__(self, fn):
        self.fn = fn
        self.key = None
        self.graph = None  # (CUDAGraph, static inputs, static output)
        self.captures = 0

    def clear(self) -> None:
        """Drop the graph and its memory pool, e.g. after new weights."""
        self.key = self.graph = None

    def __call__(self, *args: torch.Tensor):
        key = tuple(None if a is None else (a.shape, a.dtype, a.device) for a in args)
        if key != self.key:
            self.clear()
            self.graph = self._capture(args)
            self.key = key
            self.captures += 1
        graph, static_in, static_out = self.graph
        for s, a in zip(static_in, args):
            if a is not None:
                s.copy_(a)
        graph.replay()
        if isinstance(static_out, tuple):
            return tuple(o.clone() for o in static_out)
        return static_out.clone()

    def _capture(self, args):
        static_in = [None if a is None else a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self.fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of other threads (the server's finisher
        # copying a finished batch to the host) go on during the capture.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self.fn(*static_in)
        return graph, static_in, static_out


class GraphedVariants:
    """``fn(*tensors, **static)`` with one :class:`GraphedCall` per distinct
    ``static`` (keyword arguments that are not tensors; pass tensors
    positionally) and ``state()``: the (name, value) pairs of whatever else
    the traced work depends on (the UNet's int8 mode), read at each call,
    so that a change of it captures a graph of its own instead of replaying
    a stale one."""

    def __init__(self, fn, state=None):
        self.fn = fn
        self.state = state
        self.calls = {}

    def clear(self) -> None:
        """Drop every variant's graph and memory pool."""
        self.calls.clear()

    @property
    def captures(self) -> dict:
        """{variant: captures of its graph}."""
        return {k: c.captures for k, c in self.calls.items()}

    def __call__(self, *args: torch.Tensor, **static):
        key = tuple(sorted(static.items())) + (tuple(self.state()) if self.state else ())
        call = self.calls.get(key)
        if call is None:
            call = self.calls[key] = GraphedCall(functools.partial(self.fn, **static))
        return call(*args)
