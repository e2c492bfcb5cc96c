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

The tensor- and sequence-parallel layers (``models/layers.py``) use
these collectives on one mesh axis's group: :func:`all_reduce_sum` (the
row-parallel partial sums over ``model``), :func:`model_entry` (the
column-parallel layers' input), :func:`all_max_` (the int8 scales over a
split row or map), :func:`all_gather_seq` (K/V, GroupNorm statistics and
Token Merging's tokens along ``seq``) and :func:`halo_exchange` (the
neighbouring rows of a height-split map for a 3x3 conv).  Each checks
that this rank belongs to the group it is given and raises otherwise,
also without a process group: the layers call them only where an axis
is above 1.

Training over ``model`` runs backward through the split layers:
:func:`all_reduce_sum` and :func:`model_entry` are autograd Functions
where grad mode is on and the input requires grad (Megatron's g and f: a
sum forward and the identity backward, the identity forward and a sum of
the input's gradient backward), so every replicated tensor's gradient is
whole and equal on every rank.  The in-place collectives work on the
tensors' data and would cut a gradient; on a tensor that requires grad
under grad mode they raise.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sonicdiffusionbayeslab_torch.utils import env

# A collective that waits longer than this fails the rank that waits, so a
# rank that raised ends the run rather than hanging the others.
TIMEOUT_S = 600.0
# The serving control channel waits for requests, which may not come for
# hours: its group gets this timeout instead.
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0

_control: list = []  # the serving control group, made once
# One pinned host buffer per dtype, as large as the largest CUDA tensor a
# gloo collective has sent (gloo serves ranks that share one card, for
# checks): the copy to the host is then a DMA, where a pageable copy adds
# a host memcpy to every one of a split forward's ~100 collectives.
_staging: dict = {}


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
    refuses).  A group already started is kept (True).  ``coordinator``
    left None takes ``SDBL_COORDINATOR``, as in the JAX package."""
    from sonicdiffusionbayeslab_torch.utils.device import resolve_device

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = env.coordinator(coordinator)
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


def _members(group, what: str) -> int:
    """The size of ``group``, after checking that a process group exists and
    that this rank is one of ``group``'s."""
    if not is_initialized():
        raise RuntimeError(f"{what}: no process group (call parallel.initialize first)")
    if group is None:
        raise ValueError(f"{what}: no group given")
    if dist.get_rank(group) < 0:
        raise ValueError(f"{what}: rank {rank()} is not a member of the group it was given")
    return dist.get_world_size(group)


def _to_comm(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on the collective's device: itself there, a CUDA tensor's copy
    in this dtype's pinned staging buffer for gloo (the collective is done
    with it before the next one starts).  The buffer is a normal tensor
    even when made under ``torch.inference_mode`` (a sampling call), so
    that a later call outside it may write it."""
    if t.device == dev:
        return t
    if t.is_cuda and dev.type == "cpu":
        buf = _staging.get(t.dtype)
        if buf is None or buf.numel() < t.numel():
            with torch.inference_mode(False):
                buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            _staging[t.dtype] = buf
        return buf[:t.numel()].view(t.shape).copy_(t)
    return t.to(dev)


def _no_grad_through(t: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{what} works on the data of a tensor that requires grad and would "
                           "cut its gradient; the differentiable collectives are all_reduce_sum "
                           "and model_entry (training under seq is not a JAX package feature)")


def _all_reduce_(t: torch.Tensor, group, op) -> torch.Tensor:
    buf = _to_comm(t.detach(), _comm_device(group))
    dist.all_reduce(buf, op=op, group=group)
    return t if buf is t else t.copy_(buf)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place, and return it: on
    the device under NCCL, through the host under gloo.  The backends'
    ring algorithms reduce each element once and send the result to every
    rank, so every rank holds the same bits.  Raises on a tensor that
    requires grad under grad mode (:func:`all_reduce_sum` is the
    differentiable one)."""
    _members(group, "all_reduce_sum_")
    _no_grad_through(t, "all_reduce_sum_")
    return _all_reduce_(t, group, dist.ReduceOp.SUM)


def all_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest of the ranks' ``t``, in place (no gradient:
    the int8 scales)."""
    _members(group, "all_max_")
    _no_grad_through(t, "all_max_")
    return _all_reduce_(t, group, dist.ReduceOp.MAX)


class _SumForward(torch.autograd.Function):
    """Megatron's g: the sum over ``group`` forward, the identity backward
    (every rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.detach().clone(), group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum of the gradient over
    ``group`` backward (each rank's split layers give part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.detach().clone(), ctx.group, dist.ReduceOp.SUM), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``: a row-parallel layer's
    partials.  Differentiable where grad mode is on and ``t`` requires grad
    (the gradient passes through unchanged); else in place on ``t``."""
    _members(group, "all_reduce_sum")
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumForward.apply(t, group)
    return _all_reduce_(t, group, dist.ReduceOp.SUM)


def model_entry(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering layers split over ``group``: itself forward; where
    grad mode is on and ``x`` requires grad, its gradient summed over the
    group backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        _members(group, "model_entry")
        return _SumBackward.apply(x, group)
    return x


def all_gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along
    ``dim`` in rank order, on ``x``'s device: the K/V tokens or the
    GroupNorm partials of a height split in the order of the image's
    rows."""
    n = _members(group, "all_gather_seq")
    _no_grad_through(x, "all_gather_seq")
    src = _to_comm(x.detach().contiguous(), _comm_device(group))
    parts = [torch.empty(src.shape, dtype=src.dtype, device=src.device) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def halo_exchange(x: torch.Tensor, rows_above: int, rows_below: int, group,
                  dim: int = 1) -> torch.Tensor:
    """``x`` (this rank's rows of a map split along ``dim`` over ``group``
    in rank order) with the last ``rows_above`` rows of the rank above
    before it and the first ``rows_below`` rows of the rank below after it;
    zeros at the image's top and bottom edges, which is the zero padding
    of one process.  One all-gather of every rank's edge rows."""
    n = _members(group, "halo_exchange")
    _no_grad_through(x, "halo_exchange")
    r = dist.get_rank(group)
    h = x.shape[dim]
    if rows_above > h or rows_below > h:
        raise ValueError(f"halo of {rows_above}/{rows_below} rows > the local height {h}")
    edges = torch.cat([x.narrow(dim, 0, rows_below), x.narrow(dim, h - rows_above, rows_above)],
                      dim=dim)
    parts = all_gather_seq(edges.unsqueeze(0), 0, group)
    shape = list(x.shape)
    out = [x]
    if rows_above:
        shape[dim] = rows_above
        out.insert(0, parts[r - 1].narrow(dim, rows_below, rows_above) if r > 0
                   else x.new_zeros(shape))
    if rows_below:
        shape[dim] = rows_below
        out.append(parts[r + 1].narrow(dim, 0, rows_below) if r < n - 1
                   else x.new_zeros(shape))
    return torch.cat(out, dim=dim)


def all_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place, as one flat fp32 all-reduce (the ranks' shards are the same
    size, so the mean of their means is the global batch's mean)."""
    all_sum_(tensors, group, divide_by=world_size(group))


def all_sum_(tensors: Sequence[torch.Tensor], group=None, divide_by: int = 1) -> None:
    """Replace each tensor by its sum over the ranks of ``group`` (over
    ``divide_by``), in place, as one flat fp32 all-reduce (the split
    weights' and adapters' gradients over ``model``)."""
    if world_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(_comm_device(group), torch.float32)
                      for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if divide_by != 1:
        flat.div_(divide_by)
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
