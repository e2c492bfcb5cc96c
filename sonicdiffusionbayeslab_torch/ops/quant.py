"""Int8 W8A8 dynamic quantization of the UNet's matmuls and 3x3 convs.

Counterpart of ``sonicdiffusionbayeslab_tpu/ops/quant.py``.  APPROXIMATE,
like Token Merging: off unless a model's mode says otherwise, and never
part of the exact runs.  The modes are the JAX package's:

* ``int8``: the transformer projections (q/k/v/out, the GEGLU
  feed-forward, the transformers' proj_in/proj_out) through
  :func:`int8_dense`;
* ``int8_conv``: those and the UNet's ResnetBlock, Downsample and Upsample
  3x3 convs through :func:`int8_conv`;
* ``int8_conv_only``: the convs alone, the projections stay exact;
* ``None``: exact.

The JAX package keeps the mode in a process global; here it is state of a
model: :func:`set_quant_mode` writes ``quant_mode`` on a module and on
every submodule that has one (the UNet's, ``models/layers.py``), and the
VAE's convs never quantize.  An engine takes its UNet's first mode from
:func:`get_quant_mode` when it is built: ``SDBL_QUANT``, read through
``utils/env.py``.

Scheme (the standard dynamic W8A8 recipe, the JAX package's bits):
symmetric int8 with scale ``max(amax, 1e-12) / 127`` and round half to
even, clipped to +-127; activations per token (a dense) or per sample (a
conv), weights per output channel; the products accumulate in int32 and
the epilogue is ``acc * s_x * s_w + b`` in fp32, cast to the output dtype.

On a CUDA tensor the accumulation is ``torch._int_mm`` (cuBLASLt's int8
GEMM; the reference's is plain XLA, so a stock op stands here) and a conv
is that GEMM over a hand-built im2col: the kh * kw shifted NHWC slices side
by side, [B * Ho * Wo, kh * kw * C], against the weight as
[O, kh * kw * C].  ``_int_mm``'s shape rules (more than 16 rows, K and N
multiples of 8) are met by zero rows and columns, which change no sum.  On
a CPU tensor the plain version accumulates in float64, where every partial
sum of int8 products is an exact integer (an fp32 one would not be: a
3x3x1280 sum passes 2^24).  ``int8_matmul.launches`` counts the card's
GEMMs, ``int8_dense.launches`` and ``int8_conv.launches`` the card calls
of each.

Split over a mesh (``parallel/mesh.py``) the scales stay the JAX
package's global ones, which GSPMD reduces across the shards there: a
row-parallel layer's weight scale per output channel and its input's
scale per token are all-maxed over ``model`` (a column-parallel slice
keeps its rows' own scales, whole already), a conv's per-sample
activation scale over ``seq`` (its rows are split) and over ``model`` as
well for a row-parallel conv (its channels are), ``x_groups`` and
``w_groups`` below.  A row-parallel layer's int32 partial sums are summed
over ``model`` (``sum_group``; exact in int32) before the epilogue, which
adds the bias once, so every rank holds one process's int8 output.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.utils import env

MODES = (None, "int8", "int8_conv", "int8_conv_only")
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8


def check_mode(mode: Optional[str]) -> Optional[str]:
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (int8 | int8_conv | int8_conv_only | None)")
    return mode


def dense_enabled(mode: Optional[str]) -> bool:
    """The projections run int8 ('int8' and 'int8_conv')."""
    return mode in ("int8", "int8_conv")


def conv_enabled(mode: Optional[str]) -> bool:
    """The UNet's 3x3 convs run int8 ('int8_conv' and 'int8_conv_only')."""
    return mode in ("int8_conv", "int8_conv_only")


def get_quant_mode() -> Optional[str]:
    """The process default, which a new engine's UNet starts in:
    ``SDBL_QUANT`` (the JAX package's ``get_quant_mode`` falls back to it
    too; its error words where the value is unknown)."""
    return env.quant_mode()


def dense_quant_enabled() -> bool:
    """The default mode quantizes the projections ('int8', 'int8_conv')."""
    return dense_enabled(get_quant_mode())


def conv_quant_enabled() -> bool:
    """The default mode quantizes the 3x3 convs ('int8_conv', 'int8_conv_only')."""
    return conv_enabled(get_quant_mode())


def set_quant_mode(module: nn.Module, mode: Optional[str]) -> nn.Module:
    """Set ``quant_mode`` on ``module`` and each of its submodules that has
    the attribute."""
    check_mode(mode)
    for m in module.modules():
        if hasattr(m, "quant_mode"):
            m.quant_mode = mode
    return module


def _all_max(amax: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``amax`` maxed over the ranks of each of ``groups`` (the rows or
    channels the ranks split), in place."""
    if groups:
        from sonicdiffusionbayeslab_torch.parallel import distributed

        for g in groups:
            distributed.all_max_(amax, g)
    return amax


def quantize_rows(x: torch.Tensor, groups: Sequence = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: (q [..., K] int8, scale [..., 1] fp32).
    The divisor 127 is a tensor: CUDA divides by a Python number as a
    multiplication by its reciprocal, which is not the division's rounding
    (the CPU's and the JAX package's).  ``groups``: process groups over
    whose ranks the last axis is split; the largest magnitude is theirs."""
    amax = _all_max(x.abs().amax(dim=-1, keepdim=True).float(), groups)  # exact in x's dtype
    amax = amax.clamp_min(1e-12)
    scale = amax / amax.new_full((), 127.0)
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8), scale  # x / scale in fp32


def conv_weight_rows(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, kh, kw] -> [O, kh * kw * C], the im2col's column order."""
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def padded_int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(a, w.T)`` for a [M, K] and w [N, K] int8 of any
    size: zero rows and columns pad M past 16 and K and N to multiples of 8,
    and the result is cut back to [M, N] int32."""
    M, K = a.shape
    N = w.shape[0]
    pad_m, pad_k, pad_n = max(0, _MIN_ROWS - M), -K % _ALIGN, -N % _ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_n or pad_k:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:M, :N] if pad_m or pad_n else out


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times w [N, K] int8 transposed -> [M, N] int32, exact:
    cuBLASLt's int8 GEMM on a CUDA tensor, a float64 product on a CPU one."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_matmul shapes {tuple(a.shape)} x {tuple(w.shape)}^T")
    if a.device != w.device:
        raise ValueError(f"int8_matmul operands on {a.device} and {w.device}")
    if a.device.type == "cpu":
        return (a.double() @ w.double().t()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, not {a.device}")
    out = padded_int_mm(a, w)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def im2col(x: torch.Tensor, kh: int, kw: int, stride: Sequence[int],
           padding: Sequence[Sequence[int]]) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, kh * kw * C]: the zero-padded map's
    ``kh * kw`` shifted, strided slices side by side (tap-major, then C).
    A contiguous int8 map with C a multiple of 4 is moved four channels to
    a 32-bit word (the pad and the copies move a quarter of the elements)."""
    (top, bottom), (left, right) = padding
    sh, sw = stride
    words = x.dtype == torch.int8 and x.shape[-1] % 4 == 0 and x.is_contiguous()
    if words:
        x = x.view(torch.int32)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    Ho = (xp.shape[1] - kh) // sh + 1
    Wo = (xp.shape[2] - kw) // sw + 1
    cols = torch.cat([xp[:, i:i + sh * (Ho - 1) + 1:sh, j:j + sw * (Wo - 1) + 1:sw]
                      for i in range(kh) for j in range(kw)], dim=-1)
    return cols.view(torch.int8) if words else cols


def _conv_accumulate(x_q, w_q, kh, kw, stride, padding) -> torch.Tensor:
    """The int32 sums of the int8 conv, [B, Ho, Wo, O]."""
    if x_q.device.type == "cpu":
        (top, bottom), (left, right) = padding
        xp = F.pad(x_q.double(), (0, 0, left, right, top, bottom)).permute(0, 3, 1, 2)
        w = w_q.double().reshape(w_q.shape[0], kh, kw, -1).permute(0, 3, 1, 2)
        return F.conv2d(xp, w, stride=tuple(stride)).permute(0, 2, 3, 1).to(torch.int32)
    cols = im2col(x_q, kh, kw, stride, padding)
    B, Ho, Wo, K = cols.shape
    return int8_matmul(cols.reshape(-1, K), w_q).reshape(B, Ho, Wo, -1)


def _sum_partials(acc: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's int32 partial sums, summed over ``group``."""
    if group is None:
        return acc
    from sonicdiffusionbayeslab_torch.parallel import distributed

    return distributed.all_reduce_sum_(acc, group)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None,
               weight_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               x_groups: Sequence = (), sum_group=None) -> torch.Tensor:
    """W8A8 ``x [..., K] @ weight [F, K]^T + bias``: per-token activation
    and per-output-channel weight scales.  ``weight_q`` is
    ``quantize_rows(weight)`` where the caller has it.  Row-parallel:
    ``x_groups`` the groups that split K (the tokens' scales are maxed
    over them), ``sum_group`` the group whose ranks' partial sums add up."""
    K = x.shape[-1]
    x_q, s_x = quantize_rows(x, x_groups)
    w_q, s_w = weight_q if weight_q is not None else quantize_rows(weight)
    acc = int8_matmul(x_q.reshape(-1, K), w_q).reshape(*x.shape[:-1], -1)
    acc = _sum_partials(acc, sum_group)
    out = acc * s_x * s_w.reshape(-1)  # int32 * fp32: fp32
    if bias is not None:
        out = out + bias.float()
    if x.device.type == "cuda":
        int8_dense.launches += 1
    return out.to(out_dtype or x.dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: Sequence[int] = (1, 1), padding=((1, 1), (1, 1)),
              out_dtype: Optional[torch.dtype] = None,
              weight_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              x_groups: Sequence = (), sum_group=None) -> torch.Tensor:
    """W8A8 conv of x [B, H, W, C] with an OIHW ``weight`` [O, C, kh, kw]:
    per-sample activation and per-output-channel weight scales; ``padding``
    ((top, bottom), (left, right)) zeros.  ``weight_q`` is
    ``quantize_rows(conv_weight_rows(weight))`` where the caller has it.
    ``x_groups``: the groups that split a sample's rows or channels (its
    scale is maxed over them); ``sum_group``: a row-parallel conv's."""
    B = x.shape[0]
    O, _, kh, kw = weight.shape
    x_q, s_x = quantize_rows(x.reshape(B, -1), x_groups)
    w_q, s_w = weight_q if weight_q is not None else quantize_rows(conv_weight_rows(weight))
    acc = _conv_accumulate(x_q.reshape(x.shape), w_q, kh, kw, stride, padding)
    acc = _sum_partials(acc, sum_group)
    out = acc * s_x.reshape(B, 1, 1, 1) * s_w.reshape(1, 1, 1, -1)  # int32 * fp32: fp32
    if bias is not None:
        out = out + bias.float()
    if x.device.type == "cuda":
        int8_conv.launches += 1
    return out.to(out_dtype or x.dtype)


int8_dense.launches = 0
int8_conv.launches = 0


def cached_weight_q(layer: nn.Module, rows, groups: Sequence = ()) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """``quantize_rows(rows(layer.weight), groups)``, kept on ``layer``
    until the weight changes (another tensor, or an in-place write): the
    float master weights are quantized once, as the JAX package's loop
    hoists them out of its scan.  The key is the rank's share (its own
    slice of a split weight, whose storage may begin where the whole
    weight's did: hence its shape) and the groups its scales span.  Nothing is
    kept from inside a CUDA graph capture, whose memory belongs to the
    graph."""
    w = layer.weight
    key = (w.data_ptr(), tuple(w.shape), w._version, w.dtype, w.device,
           tuple(map(id, groups)))
    hit = layer.__dict__.get("_int8_weight")
    if hit is not None and hit[0] == key:
        return hit[1]
    q = quantize_rows(rows(w), groups)
    if not (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        layer.__dict__["_int8_weight"] = (key, q)
    return q


def linear_int8(layer: nn.Module, x: torch.Tensor, model_group=None) -> torch.Tensor:
    """A linear layer (or a 1x1 conv applied to tokens) in W8A8;
    ``model_group``: row-parallel over that group (its input columns and
    weight columns split, the partials summed, the bias added once)."""
    groups = () if model_group is None else (model_group,)
    wq = cached_weight_q(layer, lambda w: w.flatten(1), groups)
    split = {} if model_group is None else dict(x_groups=groups, sum_group=model_group)
    return int8_dense(x, layer.weight.flatten(1), layer.bias, weight_q=wq, **split)


def conv_int8(conv: nn.Conv2d, x: torch.Tensor, padding, seq_group=None,
              model_group=None) -> torch.Tensor:
    """An ``nn.Conv2d`` on a channels-last map in W8A8 (``padding`` as
    :func:`int8_conv`'s); ``seq_group``: the map's rows split over it;
    ``model_group``: row-parallel over it (input channels split)."""
    w_groups = () if model_group is None else (model_group,)
    x_groups = tuple(g for g in (seq_group, model_group) if g is not None)
    wq = cached_weight_q(conv, conv_weight_rows, w_groups)
    split = {} if not x_groups else dict(x_groups=x_groups, sum_group=model_group)
    return int8_conv(x, conv.weight, conv.bias, stride=conv.stride, padding=padding, weight_q=wq,
                     **split)
