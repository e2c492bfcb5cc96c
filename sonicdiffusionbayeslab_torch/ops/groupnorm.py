"""GroupNorm (+ optional SiLU) over channels-last activations, with the
hand-written CUDA kernel of ``csrc/groupnorm.cu``.

It replaces the JAX package's Pallas kernel ``_kernel``
(``sonicdiffusionbayeslab_tpu/ops/groupnorm.py``) and, unlike it, is the
port's default GroupNorm: every resnet norm, transformer input norm and
output norm of the UNet and VAE comes here.  The math is that of the JAX
default path (``models/layers.py::GroupNorm``): fp32 statistics, the
variance as the mean of squared deviations, output in x's dtype.

A CPU tensor takes ``plain_group_norm``; a CUDA tensor launches the kernel
or raises.  ``group_norm_silu.launches`` counts calls that launched it: one
kernel launch a call, a grid of thread-block clusters laid out by ``plan``.

Gradients: with grad mode on and an input that requires grad,
``group_norm_silu`` goes through ``GroupNormSiLUFn`` (on both devices),
whose forward is the same kernel or plain version and whose backward is
autograd through ``reference_group_norm``, the port's copy of the JAX
package's ``_gn_silu_ref`` (one-pass E[x²] − mean² statistics), as the JAX
package's ``_gn_bwd`` is ``jax.vjp`` of it.

Split across ranks (a height split over the mesh's ``seq`` axis): the
TPU kernel's grid has a pass axis, pass 0 accumulating each group's sums
and pass 1 applying them.  ``group_norm_silu_split`` does the same in two
hand-written launches with a collective between them:
``group_norm_partials`` (``gn_cluster_kernel``'s statistics, stopped
before the apply: per batch item and group the fp32 ``(count, mean,
M2)`` of this rank's rows), an all-gather of the partials along the axis,
``merge_group_stats`` (Chan's merge in rank order, a few torch ops on a
[B, G] tensor, so every rank gets the same bits) and
``group_norm_apply`` (``gn_apply_kernel``: ``(x - mean) * rstd * gamma +
beta`` and the SiLU with the given statistics).  Their plain versions
``plain_group_norm_partials`` and ``plain_group_norm_apply`` run on a CPU
tensor.  Each wrapper counts its launches (``.launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from sonicdiffusionbayeslab_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Plan constants (NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block).
TARGET_CTAS = 128      # about one block per SM
MAX_CLUSTER = 16       # 8 is portable; the card is asked whether it holds a cluster of 16
MIN_THREADS = 128      # a block has at least this many threads where it has the rows
MAX_THREADS = 512
ROWS_PER_THREAD = 4    # rows a thread walks where the block has that many
MIN_CTA_BYTES = 8192   # a cluster of several blocks only where each reads at least this
MIN_ROW_BYTES = 64     # a channel range spans at least 64 bytes of a row where C allows
SECTOR_BYTES = 32      # ...and never less than one DRAM sector where it must go narrower
CACHE_BYTES = 96 * 1024  # a block keeps its rows in shared memory up to this size
MAX_SMEM = 232448      # 227 KB
# A range of one lane's channels keeps mean, M2, gamma and beta in shared
# memory, 16 bytes a channel: one group of 8192 channels fits 227 KB.
MAX_CHANNELS = 8192


def resolve_groups(channels: int, num_groups: int) -> int:
    """The reference's rule: ``gcd(C, G)`` groups when C does not divide by G."""
    return num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)


def plain_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool) -> torch.Tensor:
    """x [B, ..., C] -> GroupNorm(+SiLU) with fp32 two-pass statistics."""
    C = x.shape[-1]
    xf = x.float()
    xg = xf.reshape(x.shape[0], -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def plain_group_norm_partials(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x [B, ..., C] -> [B, G, 3] fp32 ``(count, mean, M2)`` of each group
    over x's rows (M2: the sum of squared deviations from the mean)."""
    C = x.shape[-1]
    xg = x.float().reshape(x.shape[0], -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3))
    m2 = ((xg - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, xg.shape[1] * xg.shape[3]), mean, m2], dim=-1)


def merge_group_stats(parts: torch.Tensor, eps: float) -> torch.Tensor:
    """[S, B, G, 3] partials of S row slices, in row order -> [B, G, 2] fp32
    ``(mean, rstd)`` of the whole: Chan's merge of slice k into the first
    k, in that fixed order, as ``gn_cluster_kernel`` merges its blocks."""
    n, mean, m2 = parts[0].float().unbind(-1)
    for part in parts[1:]:
        nb, mb, qb = part.float().unbind(-1)
        tot = n + nb
        d = mb - mean
        mean = mean + d * (nb / tot)
        m2 = m2 + (qb + d * d * (n * nb / tot))
        n = tot
    return torch.stack([mean, torch.rsqrt(m2 / n + eps)], dim=-1)


def plain_group_norm_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, silu: bool) -> torch.Tensor:
    """x [B, ..., C] normalised with the given [B, G, 2] ``(mean, rstd)``,
    then the affine and optional SiLU in fp32; output in x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    G = stats.shape[1]
    xg = x.float().reshape(B, -1, G, C // G)
    mean, rstd = (stats[..., i].float()[:, None, :, None] for i in (0, 1))
    y = ((xg - mean) * rstd).reshape(x.shape) * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut.  The grid holds ``B * ranges`` clusters of
    ``cluster`` blocks: a cluster owns one batch item and a range of
    ``range_groups`` whole groups (``channels`` channels); its block of rank
    k owns rows ``[k * rows, (k + 1) * rows)``.  A block's ``threads`` are
    ``row_lanes`` lanes of rows by ``channels / vec`` vector slots of a row
    (a thread walks several slots where there are more slots than threads).
    ``cache``: the block keeps its rows in shared memory between the
    statistics and the apply pass, so x is read once."""
    vec: int
    range_groups: int
    channels: int
    ranges: int
    cluster: int
    rows: int
    threads: int
    row_lanes: int
    cache: bool
    smem: int
    ctas: int


# The card's residency, for the model of how many clusters it holds at once.
SM_COUNT = 132
SM_THREADS = 2048
SM_REGS = 65536
SM_SMEM = 233472       # 228 KB an SM, of which each block also takes 1 KB
REGS_PER_THREAD = 64   # the kernel's __launch_bounds__(512, 2)
# Share of the card's block slots that clusters of each size fill
# (cudaOccupancyMaxActiveClusters on an H100 SXM: a cluster must fit one GPC).
CLUSTER_PACKING = {1: 1.0, 2: 1.0, 4: 0.93, 8: 0.9, 16: 0.8}


def model_active_clusters(vec: int, cluster: int, threads: int, smem: int) -> int:
    """How many clusters of ``cluster`` blocks the card holds at once,
    modelled from threads, registers and shared memory an SM."""
    per_sm = min(SM_THREADS // threads, SM_REGS // (threads * REGS_PER_THREAD),
                 SM_SMEM // (smem + 1024), 32)
    return int(SM_COUNT * per_sm / cluster * CLUSTER_PACKING[cluster])


@functools.lru_cache(maxsize=None)
def card_active_clusters(dtype: int, vec: int, cluster: int, threads: int, smem: int) -> int:
    """The card's own answer (cudaOccupancyMaxActiveClusters) for the kernel
    instantiation of ``dtype`` (0 float32, 1 bfloat16) and ``vec``."""
    out = ctypes.c_int(0)
    _build.check(_build.kernels().sdbl_groupnorm_active_clusters(dtype, vec, cluster, threads,
                                                                 smem, ctypes.byref(out)),
                 "cudaOccupancyMaxActiveClusters")
    return out.value


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def _smem(row_lanes: int, channels: int, range_groups: int, rows: int, elem: int,
          cache: bool) -> int:
    """Bytes of dynamic shared memory, laid out as in ``groupnorm.cu``: the
    cached rows (16-byte aligned), the per-lane (mean, M2) scratch, gamma
    and beta, the block's per-group partials and the merged statistics."""
    cached = -(-rows * channels * elem // 16) * 16 if cache else 0
    return cached + 4 * (2 * row_lanes * channels + 2 * channels + 4 * range_groups)


def _layout(B: int, N: int, C: int, G: int, elem: int, vec: int, range_groups: int,
            cluster: int) -> Plan:
    gs = C // G
    channels = range_groups * gs
    slots = channels // vec
    rows = -(-N // cluster)
    lanes = max(_pow2_ceil(-(-rows // ROWS_PER_THREAD)),
                min(_pow2_ceil(-(-MIN_THREADS // slots)), _pow2_ceil(rows)))
    lanes = min(lanes, _pow2_floor(max(1, MAX_THREADS // slots)))
    threads = -(-min(MAX_THREADS, lanes * slots) // 32) * 32
    cache = rows * channels * elem <= CACHE_BYTES
    ranges = G // range_groups
    return Plan(vec=vec, range_groups=range_groups, channels=channels, ranges=ranges,
                cluster=cluster, rows=rows, threads=threads, row_lanes=lanes, cache=cache,
                smem=_smem(lanes, channels, range_groups, rows, elem, cache),
                ctas=B * ranges * cluster)


def plan(B: int, N: int, C: int, G: int, elem: int, aligned: bool = True,
         active_clusters=model_active_clusters) -> Plan:
    """The launch plan for x ``[B, N, C]`` with ``G`` groups and elements of
    ``elem`` bytes.

    16-byte vectors (8 bf16 or 4 fp32) wherever C and whole groups allow
    it and x is 16-byte aligned, else one element at a time.  A channel
    range holds whole groups, a multiple of the vector, and at least
    ``MIN_ROW_BYTES`` of a row where C has that many.  Among cluster sizes
    1, 2, 4, 8 (smallest first) and ranges (widest first) it takes the
    first layout with ``TARGET_CTAS`` blocks; where none has that many,
    the one with the most.  Only layouts whose clusters the card holds all
    at once count (``active_clusters(vec, cluster, threads, smem)``; a
    second wave would double the time), and a cluster of several blocks
    only where each block reads at least ``MIN_CTA_BYTES``.  A shape with
    the work to fill the card (``TARGET_CTAS`` blocks of ``MIN_CTA_BYTES``)
    that no such layout fills, e.g. one image at 128 channels, takes
    ranges narrower than ``MIN_ROW_BYTES`` too, down to ``SECTOR_BYTES``.  Where no layout fits one
    wave, the first that fits shared memory."""
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    gs = C // G
    vec = 16 // elem
    if not aligned or C % vec or G % (vec // math.gcd(gs, vec)):
        vec = 1
    g0 = vec // math.gcd(gs, vec)
    widths = [k for k in range(g0, G + 1, g0) if G % k == 0]
    wide = [k for k in widths if k * gs * elem >= MIN_ROW_BYTES]
    narrow = [k for k in widths if k not in wide and k * gs * elem >= SECTOR_BYTES][::-1]
    passes = [(wide or widths[-1:])[::-1]]
    if wide and narrow and B * N * C * elem >= TARGET_CTAS * MIN_CTA_BYTES:
        passes.append(narrow)
    best = fallback = None
    for widths in passes:
        for cluster in (1, 2, 4, 8, 16):
            if cluster > MAX_CLUSTER or (cluster - 1) * -(-N // cluster) >= N:
                continue  # every block of a cluster owns at least one row
            for k in widths:
                p = _layout(B, N, C, G, elem, vec, k, cluster)
                if p.smem > MAX_SMEM:
                    continue
                fallback = fallback or p
                if cluster > 1 and p.rows * p.channels * elem < MIN_CTA_BYTES:
                    continue
                if B * p.ranges > active_clusters(vec, cluster, p.threads, p.smem):
                    continue
                if p.ctas >= TARGET_CTAS:
                    return p
                if best is None or p.ctas > best.ctas:
                    best = p
    if fallback is None:
        raise ValueError(f"no GroupNorm plan fits {MAX_SMEM} bytes of shared memory for "
                         f"C={C}, G={G}")
    return best or fallback


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) with fp32 one-pass statistics (variance as
    E[x²] − mean²): the function whose gradient ``GroupNormSiLUFn``
    takes, as the JAX package's ``_gn_silu_ref``."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class GroupNormSiLUFn(torch.autograd.Function):
    """``group_norm_silu``'s kernel (CUDA) or plain version (CPU) forward,
    with the gradient of ``reference_group_norm`` as its backward; saves
    x, weight and bias.  ``groups`` is already resolved."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (groups, eps, silu)
        return _group_norm_silu(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = reference_group_norm(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """x [B, H, W, C] or [B, N, C] (channels last) -> GroupNorm(+SiLU).

    ``groups`` follows the gcd rule when C does not divide by it.  With grad
    mode on and an input that requires grad the call goes through
    ``GroupNormSiLUFn``."""
    groups = resolve_groups(x.shape[-1], groups)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormSiLUFn.apply(x, weight, bias, groups, eps, silu)
    return _group_norm_silu(x, weight, bias, groups, eps, silu)


def _group_norm_silu(x, weight, bias, groups, eps, silu):
    """The kernel on a CUDA tensor, ``plain_group_norm`` on a CPU one."""
    C = x.shape[-1]
    # Statistics and normalisation ~6 operations an element, SiLU ~4 more;
    # counted on both paths (FlopCounterMode counts no elementwise work).
    _build.add_flops((10 if silu else 6) * x.numel())
    if x.device.type == "cpu":
        return plain_group_norm(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(
            f"group_norm_silu takes float32 or bfloat16 x, weight and bias of one dtype, "
            f"got {x.dtype}/{weight.dtype}/{bias.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected [B, ..., C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu's kernel reads contiguous channels-last [B, ..., C] "
                         f"tensors; got strides {x.stride()} for shape {tuple(x.shape)}")
    if weight.shape != (C,) or bias.shape != (C,) or not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"weight and bias must be contiguous [{C}]")
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")
    B = x.shape[0]
    N = x.numel() // (B * C)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        p = card_plan(B, N, C, groups, _DTYPES[x.dtype], x.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernels().sdbl_groupnorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, N, C, groups, p.vec, p.range_groups, p.cluster, p.threads, p.row_lanes,
            int(p.cache), float(eps), int(bool(silu)), _DTYPES[x.dtype], stream,
        )
    _build.check(err, "group_norm_silu")
    _build.count_launch(group_norm_silu)
    return y


group_norm_silu.launches = 0


def _check_kernel_inputs(x: torch.Tensor, what: str, *params: torch.Tensor) -> None:
    """The kernels' device, dtype, shape and stride rules."""
    C = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _DTYPES or any(p.dtype != x.dtype for p in params):
        raise TypeError(f"{what} takes float32 or bfloat16 x, weight and bias of one dtype, "
                        f"got {[t.dtype for t in (x, *params)]}")
    if x.dim() < 3:
        raise ValueError(f"expected [B, ..., C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}'s kernel reads contiguous channels-last [B, ..., C] tensors; "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    if any(p.shape != (C,) or not p.is_contiguous() or p.device != x.device for p in params):
        raise ValueError(f"weight and bias must be contiguous [{C}] on {x.device}")
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")


def group_norm_partials(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x [B, ..., C] -> [B, G, 3] fp32 ``(count, mean, M2)`` of each of the
    ``groups`` groups over x's rows: ``gn_cluster_kernel``'s Welford and
    Chan merges, stopped before the apply, on a CUDA tensor (laid out by
    ``card_plan``, without the row cache); ``plain_group_norm_partials``
    on a CPU one."""
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"channels {C} not divisible by groups {groups}")
    _build.add_flops(4 * x.numel())
    if x.device.type == "cpu":
        return plain_group_norm_partials(x, groups)
    _check_kernel_inputs(x, "group_norm_partials")
    B = x.shape[0]
    N = x.numel() // (B * C)
    stats = torch.empty(B, groups, 3, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        p = card_plan(B, N, C, groups, _DTYPES[x.dtype], x.data_ptr() % 16 == 0)
        err = _build.kernels().sdbl_groupnorm_partials(
            x.data_ptr(), stats.data_ptr(), B, N, C, groups, p.vec, p.range_groups, p.cluster,
            p.threads, p.row_lanes, _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_partials")
    _build.count_launch(group_norm_partials)
    return stats


group_norm_partials.launches = 0


def group_norm_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, silu: bool = True) -> torch.Tensor:
    """x [B, ..., C] with the given [B, G, 2] fp32 ``(mean, rstd)`` ->
    ``(x - mean) * rstd * weight + bias`` (+ SiLU) in x's dtype:
    ``gn_apply_kernel`` on a CUDA tensor, ``plain_group_norm_apply`` on a
    CPU one."""
    B, C = x.shape[0], x.shape[-1]
    if stats.dim() != 3 or stats.shape[0] != B or stats.shape[2] != 2 or C % stats.shape[1]:
        raise ValueError(f"stats {tuple(stats.shape)} is not [{B}, G, 2] with G dividing {C}")
    _build.add_flops((6 if silu else 2) * x.numel())
    if x.device.type == "cpu":
        return plain_group_norm_apply(x, stats, weight, bias, silu)
    _check_kernel_inputs(x, "group_norm_apply", weight, bias)
    if (stats.dtype != torch.float32 or stats.device != x.device
            or not stats.is_contiguous()):
        raise ValueError("stats must be contiguous float32 on x's device")
    N = x.numel() // (B * C)
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16 or y.data_ptr() % 16:
        vec = 1
    with torch.cuda.device(x.device):
        err = _build.kernels().sdbl_groupnorm_apply(
            x.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, N, C, stats.shape[1], vec, int(bool(silu)), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_apply")
    _build.count_launch(group_norm_apply)
    return y


group_norm_apply.launches = 0


def group_norm_silu_split(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          groups: int, eps: float, silu: bool, group) -> torch.Tensor:
    """GroupNorm(+SiLU) of a map whose rows are split over the ranks of
    ``group`` (this rank's rows in ``x``): the partials of the local rows,
    gathered in rank order, merged, applied.  Inference only: the JAX
    package trains under ``data`` and ``model``, never ``seq``."""
    from sonicdiffusionbayeslab_torch.parallel import distributed

    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError("GroupNorm across a seq split has no gradient: training under "
                                  "seq is not a JAX package feature")
    groups = resolve_groups(x.shape[-1], groups)
    parts = distributed.all_gather_seq(group_norm_partials(x, groups)[None], 0, group)
    return group_norm_apply(x, merge_group_stats(parts, eps), weight, bias, silu)


@functools.lru_cache(maxsize=None)
def card_plan(B: int, N: int, C: int, G: int, dtype: int, aligned: bool) -> Plan:
    """``plan`` with the card's own occupancy answers; ``dtype`` 0 float32,
    1 bfloat16."""
    return plan(B, N, C, G, 4 if dtype == 0 else 2, aligned,
                functools.partial(card_active_clusters, dtype))
