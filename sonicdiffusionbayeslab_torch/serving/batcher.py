"""Micro-batching inference front end.

Counterpart of ``sonicdiffusionbayeslab_tpu/serving/batcher.py``.  A
pipeline's throughput comes from full batches, and on a GPU each new batch
shape captures new CUDA graphs.  The batcher therefore:

- coalesces concurrent requests into one batch per (steps, guidance,
  height, width) group, waiting at most ``max_wait_ms`` for stragglers;
- always pads the prompt list to ``max_batch`` (the padding rows are empty
  prompts whose outputs are dropped), so the graphs are captured once per
  group and a request's image does not depend on the batch's size;
- gives each request its own random streams (``sample_indices``: an
  explicit seed's, else one from a server-wide counter), so its image does
  not depend on which requests share its batch (on the GPU it depends on
  its row by rounding: the UNet's library matmuls or convolutions sum a
  row at another position in another order);
- overlaps batches (``pipeline_depth`` > 1): the worker gets the images as
  the device's tensor (``output_type="device"``, ``time_loop=False``),
  rounds them to uint8 on the device and hands the copy to the host and
  the futures to a finisher thread, so batch N+1's encode and denoising
  loop queue while batch N's copy runs.  The finisher's queue holds at
  most ``pipeline_depth - 1`` batches, which bounds the device memory in
  flight.

A pipeline on a data-parallel mesh (``mesh_data`` N > 1, one process a
rank) is served from rank 0: for each batch the worker broadcasts the
call's arguments on a control group (``parallel.distributed.
control_group``) and every other rank, in :func:`follow`, makes the same
call, so the ranks sample their rows together and rank 0 gets the
gathered images.  When the worker stops it broadcasts a stop, which
releases the followers.

On the GPU the copy must not wait behind the next batch: the worker records
a CUDA event after batch N's decode and round, and the finisher waits on
that event and copies on a side stream into pinned memory (a plain
``.cpu()`` in the finisher would run on the default stream, behind batch
N+1's kernels).  The worker's CUDA-graph captures and the finisher's copy
may run at once: ``utils/cuda_graph.py`` captures in ``thread_local`` mode.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel.mesh import axis_size


class ServerOverloadedError(RuntimeError):
    """Raised by ``submit`` when the pending requests reached
    ``max_pending`` (HTTP 429's analogue): back off and retry."""


@dataclasses.dataclass
class GenerateRequest:
    prompt: str
    num_inference_steps: int = 20
    guidance_scale: float = 7.5
    negative_prompt: str = ""
    seed: Optional[int] = None  # None: a stream from the server's counter
    height: Optional[int] = None  # non-square generation (multiples of 8)
    width: Optional[int] = None
    # Queue-wait budget: a request that has not started running within
    # this many seconds of its submission fails with TimeoutError.
    timeout_s: Optional[float] = None


@dataclasses.dataclass
class _Pending:
    request: GenerateRequest
    future: Future
    index: int  # the server-wide counter -> the request's random stream
    deadline: Optional[float] = None  # time.monotonic() cut-off (timeout_s)
    resolved: bool = False  # guarded by the server's lock: resolve once


def quantize_uint8(images: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1] -> uint8 by ``clip(x * 255 + 0.5, 0, 255)``
    truncated, the host's ``data/imageio.py::encode_png_bytes`` round, in
    fp32 on the tensor's device.  The multiply and the add are separate
    kernels, so no fused multiply-add rounds differently from the host."""
    x = images.float() * 255.0
    x = x + 0.5
    return x.clamp_(0.0, 255.0).to(torch.uint8)


def quantize_uint8_host(images: np.ndarray) -> np.ndarray:
    return np.clip(images.astype(np.float32) * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


class InferenceServer:
    """A pipeline (a ``models_registry`` instance with its scheduler)
    behind a thread-safe ``submit`` -> Future API.  ``finisher_wait_s``
    sums the worker's waits for room in the finisher's queue."""

    def __init__(self, pipe, max_batch: int = 8, max_wait_ms: float = 25.0,
                 max_pending: int = 256, pipeline_depth: int = 2,
                 readback_dtype: str = "uint8"):
        self.pipe = pipe
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_pending = int(max_pending)
        self.pipeline_depth = max(1, int(pipeline_depth))
        if readback_dtype not in ("uint8", "float32"):
            raise ValueError(
                f"readback_dtype must be 'uint8' or 'float32', got {readback_dtype!r}")
        # uint8: round on the device before the copy to the host (4x fewer
        # bytes); the PNG bytes are those of the float32 path.
        self.readback_dtype = readback_dtype
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._backlog: "collections.deque[_Pending]" = collections.deque()
        self._counter = 0
        self._pending = 0  # queued and backlogged, not yet resolved
        self._counter_lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self.stats: Dict[str, Any] = {
            "requests": 0, "images": 0, "batches": 0, "errors": 0,
            "rejected": 0, "timeouts": 0, "batch_seconds": 0.0,
        }
        self.finisher_wait_s = 0.0
        # The followers' channel when the pipeline is data-parallel.
        self._control = None
        if axis_size(getattr(pipe, "mesh", None), "data") > 1:
            if distributed.rank() != 0:
                raise ValueError("rank 0 serves a data-parallel pipeline; the other ranks run "
                                 "serving.batcher.follow(pipe)")
            self._control = distributed.control_group()
        self._finisher: Optional[threading.Thread] = None
        if self.pipeline_depth > 1:
            self._finish_queue: "queue.Queue" = queue.Queue(maxsize=self.pipeline_depth - 1)
            self._finisher = threading.Thread(target=self._finish_loop, daemon=True)
            self._finisher.start()
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, request: GenerateRequest) -> Future:
        if self._stop.is_set() or self._draining.is_set():
            raise RuntimeError("server is shut down")
        if request.seed is not None and not isinstance(request.seed, (int, np.integer)):
            # Checked in the caller's thread: a bad seed is the submitter's
            # error, never the worker's death.
            raise ValueError(f"seed must be an integer or null, got {request.seed!r}")
        with self._counter_lock:
            if self._pending >= self.max_pending:
                self.stats["rejected"] += 1
                raise ServerOverloadedError(
                    f"{self._pending} requests pending (max_pending="
                    f"{self.max_pending}); back off and retry")
            self._pending += 1
            idx = self._counter
            self._counter += 1
        fut: Future = Future()
        deadline = (time.monotonic() + float(request.timeout_s)
                    if request.timeout_s is not None else None)
        self._queue.put(_Pending(request, fut, idx, deadline))
        return fut

    def generate(self, request: GenerateRequest, timeout: Optional[float] = None):
        return self.submit(request).result(timeout)

    def _resolve(self, p: _Pending, *, result=None, exc=None) -> None:
        with self._counter_lock:
            if p.resolved:
                return
            p.resolved = True
            self._pending -= 1
        # Outside the lock: done-callbacks run here and may call submit().
        if exc is not None:
            p.future.set_exception(exc)
        else:
            p.future.set_result(result)

    def _expired(self, p: _Pending) -> bool:
        """Fail (and consume) a pending item whose queue-wait deadline passed."""
        if p.deadline is not None and time.monotonic() > p.deadline:
            self.stats["timeouts"] += 1
            self._resolve(p, exc=TimeoutError(
                f"request waited > {p.request.timeout_s}s in queue"))
            return True
        return False

    def shutdown(self, wait: bool = True, drain: bool = False) -> None:
        """Stop the server.  ``drain=True``: refuse new submissions and finish
        everything queued first; ``drain=False``: stop after the batch in
        flight and fail the rest at once."""
        if drain:
            self._draining.set()
            self._queue.put(None)  # wake the worker if it is idle
            if wait:
                self._worker.join(timeout=300)
        self._stop.set()
        self._queue.put(None)
        if wait:
            self._worker.join(timeout=30)
        # What the worker handed off resolves before the rest fails: the
        # worker is joined, so no later put races the sentinel.
        if self._finisher is not None:
            self._finish_queue.put(None)
            if wait:
                self._finisher.join(timeout=60)
        err = RuntimeError("server is shut down")
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                self._resolve(p, exc=err)
        for p in self._backlog:
            self._resolve(p, exc=err)
        self._backlog.clear()

    # ------------------------------------------------------------- worker
    @staticmethod
    def _group_key(r: GenerateRequest):
        # The shape is part of the graphs' signature, so of the group too.
        return (int(r.num_inference_steps), float(r.guidance_scale), r.height, r.width)

    def _loop(self) -> None:
        try:
            self._serve()
        finally:
            if self._control is not None:  # release the followers
                distributed.broadcast_object(("stop",), group=self._control)

    def _call_pipe(self, prompts, kw):
        """The pipeline call, sent to the followers first where there are
        any."""
        if self._control is not None:
            distributed.broadcast_object(("call", prompts, kw), group=self._control)
        return self.pipe(prompts, **kw)

    def _serve(self) -> None:
        while not self._stop.is_set():
            # Backlog first: requests spilled from earlier cycles are older
            # than anything queued, so one signature's stream cannot starve
            # another's.
            item = None
            while item is None:
                if self._stop.is_set():
                    return
                if self._backlog:
                    item = self._backlog.popleft()
                elif self._draining.is_set():
                    # Draining: serve what is still queued, then stop.
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        return
                else:
                    item = self._queue.get()
                if item is not None and self._expired(item):
                    item = None
            batch = [item]
            key = self._group_key(item.request)
            for p in list(self._backlog):
                if len(batch) >= self.max_batch:
                    break
                if self._expired(p):
                    self._backlog.remove(p)
                elif self._group_key(p.request) == key:
                    self._backlog.remove(p)
                    batch.append(p)
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                if self._expired(nxt):
                    continue
                if self._group_key(nxt.request) == key:
                    batch.append(nxt)
                else:
                    self._backlog.append(nxt)  # older first next cycle
            try:
                self._run_batch(batch)
            except Exception as e:  # the worker must never die
                with self._counter_lock:
                    self.stats["errors"] += len(batch)
                for p in batch:
                    self._resolve(p, exc=e)

    def _batch_args(self, batch: List[_Pending]):
        """(prompts, keyword arguments) of the pipeline call for ``batch``,
        padded to ``max_batch``."""
        reqs = [p.request for p in batch]
        pad = self.max_batch - len(reqs)
        # An explicit seed's stream is odd, the counter's even: an explicit
        # seed never collides with another request's assigned stream.
        indices = np.asarray(
            [int(r.seed) * 2 + 1 if r.seed is not None else (0x5E4E + p.index) * 2
             for r, p in zip(reqs, batch)] + [0] * pad, np.int64)
        size_kw = {}
        if reqs[0].height is not None or reqs[0].width is not None:
            size_kw = dict(height=reqs[0].height, width=reqs[0].width)
        return [r.prompt for r in reqs] + [""] * pad, dict(
            num_inference_steps=reqs[0].num_inference_steps,
            guidance_scale=reqs[0].guidance_scale,
            negative_prompt=[r.negative_prompt for r in reqs] + [""] * pad,
            sample_indices=indices, seed=0, output_type="device", time_loop=False, **size_kw)

    def _run_batch(self, batch: List[_Pending]) -> None:
        n = len(batch)
        prompts, kw = self._batch_args(batch)
        pipelined = self._finisher is not None and self._finisher.is_alive()
        t0 = time.perf_counter()
        ready = None
        try:
            # Without the loop's synchronisation the encode, loop, decode and
            # round all queue on the device; execution_time is then the
            # batch's wall clock to host pixels (_finalize).
            images, exec_time, _ = self._call_pipe(prompts, kw)
            if isinstance(images, torch.Tensor):
                if self.readback_dtype == "uint8":
                    images = quantize_uint8(images)
                if images.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record()
        except Exception as e:  # every caller gets the failure
            with self._counter_lock:
                self.stats["errors"] += len(batch)
            for p in batch:
                self._resolve(p, exc=e)
            return
        nfe = self.pipe.num_timesteps  # now: the next call may change it
        item = (batch, n, images, ready, exec_time, nfe, t0)
        if pipelined:
            # Blocks only while pipeline_depth - 1 batches await their copy.
            t_put = time.perf_counter()
            self._finish_queue.put(item)
            self.finisher_wait_s += time.perf_counter() - t_put
            return
        self._finish_item(item)

    def _finish_loop(self) -> None:
        """The copy stage: each batch's images to the host, while the
        worker runs the next batch."""
        while True:
            item = self._finish_queue.get()
            if item is None:
                # Shutdown (after the worker's last put): finish the rest.
                while True:
                    try:
                        item = self._finish_queue.get_nowait()
                    except queue.Empty:
                        return
                    if item is not None:
                        self._finish_item(item)
                return
            self._finish_item(item)

    @staticmethod
    def _to_host(images, ready) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            return np.asarray(images)
        if not images.is_cuda:
            return images.numpy()
        with torch.cuda.device(images.device):
            side = torch.cuda.Stream()
            side.wait_event(ready)
            host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                host.copy_(images, non_blocking=True)
            images.record_stream(side)
            side.synchronize()
        return host.numpy()

    def _finish_item(self, item) -> None:
        batch, n, images, ready, exec_time, nfe, t0 = item
        try:
            host = self._to_host(images, ready)
        except Exception as e:  # a deferred device error surfaces here
            with self._counter_lock:
                self.stats["errors"] += len(batch)
            for p in batch:
                self._resolve(p, exc=e)
            return
        self._finalize(batch, n, host, exec_time, nfe, t0)

    def _finalize(self, batch: List[_Pending], n: int, images: np.ndarray,
                  exec_time: float, nfe: int, t0: float) -> None:
        if self.readback_dtype == "uint8" and images.dtype != np.uint8:
            # Pipelines that return host arrays (test doubles) round here.
            images = quantize_uint8_host(images)
        wall = time.perf_counter() - t0
        if not isinstance(exec_time, (int, float)) or exec_time < 0:
            # The loop was not timed: report the batch's wall clock from
            # the call to host pixels, the serving figure.
            exec_time = wall
        with self._counter_lock:
            self.stats["requests"] += len(batch)
            self.stats["images"] += len(batch)
            self.stats["batches"] += 1
            # Overlapped batches' spans overlap: the sum can pass the
            # elapsed time under pipeline_depth > 1.
            self.stats["batch_seconds"] += wall
        for i, p in enumerate(batch):
            self._resolve(p, result={
                "image": images[i],
                "execution_time": exec_time,
                "batch_size": n,
                "nfe": nfe,
            })


def follow(pipe) -> int:
    """A rank other than 0 of a data-parallel server: make each pipeline
    call that rank 0's :class:`InferenceServer` broadcasts (its images,
    gathered to every rank, are rank 0's to return) until the stop;
    returns the number of calls.  A call that raises here raises alike on
    rank 0 (the same arguments and weights), so the follower reports it
    and waits for the next."""
    group = distributed.control_group()
    calls = 0
    while True:
        msg = distributed.broadcast_object(None, group=group)
        if msg[0] == "stop":
            return calls
        _, prompts, kw = msg
        try:
            pipe(prompts, **kw)
        except Exception as e:  # rank 0's batch fails with the same error
            print(f"rank {distributed.rank()}: pipeline call failed: {e!r}", flush=True)
        calls += 1
