"""A CUDA graph around a module call, for the denoising loop.

Eager PyTorch spends more host time on one SD-1.5 UNet forward at batch 4
in bf16 than an NVIDIA H100 needs to run it, so an eager loop waits on the
host.  ``GraphedCall`` captures the call for one input signature (shapes,
dtypes, devices) and then replays it: the inputs are copied into the
graph's static buffers, the graph is launched, and a copy of its output is
returned (so that outputs of two replays never alias).  The first call of a
signature runs it twice eagerly (cuDNN and cuBLAS pick their algorithms,
the kernels set their attributes) and captures it; that is set-up, like a
compile.

Only the last signature's graph is kept: a call with another signature
drops the graph before it captures the new one, so its private memory
pool (the call's activations) goes back to the caching allocator.  A
caller that alternates between shapes pays a capture at each change.
"""

from __future__ import annotations

import torch


class GraphedCall:
    """``fn(*tensors) -> tensor`` replayed from a CUDA graph of the last
    input signature it was called with."""

    WARMUP = 2

    def __init__(self, fn):
        self.fn = fn
        self.key = None
        self.graph = None  # (CUDAGraph, static inputs, static output)

    def clear(self) -> None:
        """Drop the graph and its memory pool, e.g. after new weights."""
        self.key = self.graph = None

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        if key != self.key:
            self.clear()
            self.graph = self._capture(args)
            self.key = key
        graph, static_in, static_out = self.graph
        for s, a in zip(static_in, args):
            s.copy_(a)
        graph.replay()
        return static_out.clone()

    def _capture(self, args):
        static_in = [a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self.fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(*static_in)
        return graph, static_in, static_out
