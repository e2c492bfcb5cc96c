"""Multi-process helpers over ``torch.distributed``.

Counterpart of ``sonicdiffusionbayeslab_tpu/parallel/distributed.py``.
The JAX package drives every chip of a host from one process; the torch
idiom is one process per GPU (``torchrun --nproc_per_node N``), so a rank
is a process and the collectives are NCCL's on CUDA and gloo's on the CPU.

:func:`initialize` starts the process group when a cluster is configured
and is a no-op (False) otherwise, so entry points call it unconditionally.
:func:`all_sum_scalar` and :func:`all_sum_array` sum host values across
the ranks in float64 (the metrics' global statistics); in one process they
are the identity.  The other helpers are the port's collectives on
tensors: rows gathered along a group, gradients averaged, one object sent
from rank 0.  Gloo has no CUDA ``all_gather``, so under gloo a CUDA tensor
is gathered through the host; NCCL gathers on the device.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# A collective that waits longer than this fails the rank that waits, so a
# rank that raised ends the run rather than hanging the others.
TIMEOUT_S = 600.0
# The serving control channel waits for requests, which may not come for
# hours: its group gets this timeout instead.
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0

_control: list = []  # the serving control group, made once


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> bool:
    """Start the default process group and return True, or return False
    and do nothing when no cluster is configured.

    A cluster is configured by the arguments (``coordinator``
    ``"host:port"`` of rank 0's store, ``num_processes`` and
    ``process_id``: ``tcp://``) or by ``torchrun``'s environment
    (``WORLD_SIZE`` > 1: ``env://``).  ``device`` (CUDA unless given) picks
    the backend, NCCL on CUDA and gloo on the CPU, and on CUDA the rank's
    GPU (``LOCAL_RANK``, else the rank modulo the GPUs); ``backend``
    overrides the choice (gloo for ranks that share one GPU, which NCCL
    refuses).  A group already started is kept (True)."""
    from sonicdiffusionbayeslab_torch.utils.device import resolve_device

    if dist.is_available() and dist.is_initialized():
        return True
    given = (coordinator, num_processes, process_id)
    if any(a is not None for a in given):
        if any(a is None for a in given):
            raise ValueError("initialize needs coordinator, num_processes and process_id "
                             f"together, got {given}")
        init = dict(init_method=f"tcp://{coordinator}", world_size=int(num_processes),
                    rank=int(process_id))
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init = dict(init_method="env://")
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = int(init.get("rank", os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **init)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (the world by default); 0 alone."""
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or a process with no group: the one that writes files."""
    return rank() == 0


def _comm_device(group=None) -> torch.device:
    """Where ``group``'s collectives take their tensors: the rank's GPU
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_sum_scalar(x: float) -> float:
    """Sum a host scalar across the ranks in float64 (the identity in one
    process)."""
    if world_size() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return float(t.item())


def all_sum_array(x) -> np.ndarray:
    """Sum a host array across the ranks in float64, elementwise (the
    identity in one process)."""
    if world_size() == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.asarray(x, np.float64)).to(_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def all_max_scalar(x: float, group=None) -> float:
    """The largest of the ranks' values of a host scalar."""
    if world_size(group) == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=_comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def all_gather_rows(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along
    ``dim`` in rank order, on ``t``'s device."""
    n = world_size(group)
    if n == 1:
        return t
    dev = _comm_device(group)
    src = t.detach().contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place, as one flat fp32 all-reduce (the ranks' shards are the same
    size, so the mean of their means is the global batch's mean)."""
    n = world_size(group)
    if n == 1 or not tensors:
        return
    dev = _comm_device(group)
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(n)
    off = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[off:off + k].view(t.shape))
        off += k


def broadcast_object(obj=None, src: int = 0, group=None):
    """Rank ``src``'s ``obj`` (any picklable value) on every rank."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def control_group():
    """A gloo group of every rank whose collectives wait up to
    CONTROL_TIMEOUT_S: the serving leader's channel to its followers, which
    may idle between requests.  Collective: every rank makes it once, in
    the same order as its other groups."""
    if not _control:
        _control.append(dist.new_group(backend="gloo",
                                       timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S)))
    return _control[0]
