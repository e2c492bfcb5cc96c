"""Building blocks of the SD model stack in PyTorch.

Counterparts of ``sonicdiffusionbayeslab_tpu/models/layers.py`` (the main
path's blocks).  Conventions:

* Activations are channels-last at every block boundary, [B, H, W, C] maps
  and [B, N, C] tokens, as in the JAX package.  A conv sees the map through
  ``permute(0, 3, 1, 2)``, an NCHW view with channels_last strides, so
  cuDNN runs it in NHWC and its output permutes back without a copy.
* Parameters carry diffusers state-dict names and torch layouts (OIHW
  convs, [out, in] linears); SD-1.5's transformer ``proj_in``/``proj_out``
  are 1x1 convs applied to the token matrix as linears, SD-2.x's and
  SDXL's are linears.
* Each module computes in its parameters' dtype; GroupNorm statistics and
  the softmax run in fp32.
* GroupNorm goes through ``ops.groupnorm.group_norm_silu`` and attention
  through ``ops.attention.dot_product_attention``: the hand-written CUDA
  kernels on a CUDA tensor, their plain versions on a CPU tensor; where a
  backward is recorded, inside the ops' autograd Functions.
* Modules with int8 call sites (``_Quantizable``) read their
  ``quant_mode``, which ``ops.quant.set_quant_mode`` sets on a whole model
  (the JAX package's ``projection_dense``, ``QuantDense`` and
  ``QuantConv``): the projections run ``int8_dense`` under ``int8`` and
  ``int8_conv``, the 3x3 convs of a module built with ``allow_quant`` run
  ``int8_conv`` under ``int8_conv`` and ``int8_conv_only``.  The weights
  stay float masters.
* Split execution (ROADMAP A9): ``parallel.mesh.place_module`` gives a
  module its ``par`` (a ``ParallelContext``) and calls each ``tp_shard_``,
  which keeps the rank's share of the weights.  Under ``model``,
  ``Attention`` keeps its heads (the IP-Adapter's ``to_k_ip``/``to_v_ip``
  too), ``GEGLUFeedForward`` its hidden units (the same rows of both GEGLU
  halves), ``ResnetBlock`` its ``conv1`` output channels and ``norm2``'s
  groups; the output projection (``to_out.0``, ``ff.net.2``, ``conv2``)
  takes the local input and sums the partials across the axis in fp32,
  adding its bias once after the sum.  A layer whose heads or hidden
  units the axis does not divide keeps its whole weights and runs
  unsplit.  ``TimestepEmbedMLP``, the VAE's resnets and attention (one
  512-wide head, which a split would cut) and the CLIP towers are never
  split.  Under ``seq`` a module sees its rank's rows of each map: the
  3x3 convs take halo rows from their neighbours (zeros at the image's
  edges, the padding of one process), ``GroupNorm`` merges its statistics
  across the axis with the split kernel pair of ``ops/groupnorm.py``, and
  self-attention runs the local queries against K and V gathered along
  the axis in the image's row order; Token Merging gathers a block's
  tokens along the axis and matches over the whole map.  Int8 takes its
  scales over the whole rows and maps (``ops/quant.py``), as one process.
  Training under ``model`` runs backward through the split layers: their
  inputs enter through ``distributed.model_entry`` and their partial sums
  go through ``distributed.all_reduce_sum``, so every replicated tensor's
  gradient is whole on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.ops import quant
from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention
from sonicdiffusionbayeslab_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_split,
    resolve_groups,
)
from sonicdiffusionbayeslab_torch.ops.tome import shared_matching
from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel.mesh import take_local


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to a channels-last [B, H, W, C] map."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv_padded(conv: nn.Conv2d, x: torch.Tensor, padding=((1, 1), (1, 1)),
                bias: bool = True) -> torch.Tensor:
    """``conv`` on a channels-last map with ``padding`` zeros ((top,
    bottom), (left, right)) in place of its own, without its bias where
    ``bias`` is False."""
    (top, bottom), (left, right) = padding
    if bias and tuple(conv.padding) == (top, left) and top == bottom and left == right:
        return conv_nhwc(conv, x)
    if top != bottom or left != right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
        top = left = 0
    return F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias if bias else None,
                    conv.stride, (top, left)).permute(0, 2, 3, 1)


def halo_rows(x: torch.Tensor, padding, stride: int, par):
    """(``x`` with its neighbours' halo rows, the padding left to apply) for
    a 3x3 conv of stride 1 or 2 on a height split over ``seq``: the rows
    the padding would add above and below come from the ranks above and
    below instead (zeros at the image's edges).  A stride-2 conv of an
    even local height reads no row below it."""
    (top, bottom), lr = padding
    if stride == 2:
        if x.shape[1] % 2:
            raise ValueError(f"a stride-2 conv under seq needs an even local height, got "
                             f"{x.shape[1]}")
        bottom = 0
    elif stride != 1:
        raise ValueError(f"a conv of stride {stride} does not split over seq")
    if top or bottom:
        x = distributed.halo_exchange(x, top, bottom, par.seq_group)
    return x, ((0, 0), lr)


def seq_conv(conv: nn.Conv2d, x: torch.Tensor, par) -> torch.Tensor:
    """A conv with its own padding outside the int8 call sites (``conv_in``,
    ``conv_out``, the ControlNet's conditioning embedding) on this rank's
    rows: halo rows in place of the padding where the height is split over
    ``seq``."""
    (ph, pw) = conv.padding
    padding = ((ph, ph), (pw, pw))
    if par is not None and par.n_seq > 1:
        x, padding = halo_rows(x, padding, conv.stride[0], par)
    return conv_padded(conv, x, padding)


def reduce_partial(y: torch.Tensor, bias: Optional[torch.Tensor], par,
                   dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel layer's output: this rank's partial ``y`` summed over
    the ``model`` axis in fp32, the bias added once after the sum, cast to
    ``dtype`` once (differentiable where a gradient is recorded)."""
    y = distributed.all_reduce_sum(y.float(), par.model_group)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def linear_reduce(layer: nn.Module, x: torch.Tensor, par) -> torch.Tensor:
    """A row-parallel projection (a linear, or a 1x1 conv as the linear it
    is) of this rank's input columns ``x``."""
    return reduce_partial(F.linear(x, layer.weight.flatten(1)), layer.bias, par, x.dtype)


def keep_slice_(layer: nn.Module, attr: str, dim: int, index: int, count: int,
                halves: int = 1) -> tuple:
    """Replace ``layer.<attr>`` by its ``index``-th of ``count`` slices
    along ``dim``; ``halves`` stacked blocks (GEGLU's ``[h ; gate]``) are
    each cut alike.  Conv weights stay channels_last.  Returns the cut,
    ``(dim, halves)``, which each ``tp_shard_`` reports to
    ``parallel.mesh.place_module``."""
    p = getattr(layer, attr)
    if p is None:
        return dim, halves
    keep = take_local(p.detach(), dim, index, count, halves)
    fmt = torch.channels_last if keep.dim() == 4 else torch.contiguous_format
    setattr(layer, attr, nn.Parameter(keep.contiguous(memory_format=fmt),
                                      requires_grad=p.requires_grad))
    if attr == "weight":
        for name, d in (("out_features", 0), ("in_features", 1), ("out_channels", 0),
                        ("in_channels", 1), ("embedding_dim", 1)):
            if hasattr(layer, name):
                setattr(layer, name, int(keep.shape[d]))
    return dim, halves


class _Quantizable(nn.Module):
    """A module with int8 call sites; ``quant_mode`` None is exact.
    ``par``: the ``ParallelContext`` of a placed module, else None."""

    quant_mode: Optional[str] = None
    allow_quant = False
    par = None

    def _proj(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A projection (a linear, or a 1x1 conv applied to tokens as the
        linear it is) on [..., C] tokens."""
        if quant.dense_enabled(self.quant_mode):
            return quant.linear_int8(layer, x)
        return F.linear(x, layer.weight.flatten(1), layer.bias)

    def _proj_reduce(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel projection of this rank's input columns ``x``:
        the partials summed over ``model``, the bias added once; int8 with
        the whole rows' scales under the dense modes."""
        if quant.dense_enabled(self.quant_mode):
            return quant.linear_int8(layer, x, self.par.model_group)
        return linear_reduce(layer, x, self.par)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor, padding=((1, 1), (1, 1)),
              reduce: bool = False) -> torch.Tensor:
        """A 3x3 conv on a channels-last map with ``padding`` zeros
        ((top, bottom), (left, right)); int8 where ``allow_quant``; halo rows
        in place of the padding where the height is split over ``seq``.
        ``reduce``: row-parallel over ``model`` (this rank's input
        channels; the partials summed, the bias added once).  Int8 takes a
        sample's activation scale over the ranks that split its rows or
        channels."""
        par = self.par
        seq = par is not None and par.n_seq > 1
        if seq:
            x, padding = halo_rows(x, padding, conv.stride[0], par)
        if self.allow_quant and quant.conv_enabled(self.quant_mode):
            split = {**({"seq_group": par.seq_group} if seq else {}),
                     **({"model_group": par.model_group} if reduce else {})}
            return quant.conv_int8(conv, x, padding, **split)
        if reduce:
            return reduce_partial(conv_padded(conv, x, padding, bias=False), conv.bias, par,
                                  x.dtype)
        return conv_padded(conv, x, padding)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim] fp32, cos before sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedMLP(nn.Module):
    """time_embedding: Linear -> SiLU -> Linear (diffusers TimestepEmbedding).

    With ``cond_dim`` it also has diffusers' bias-free ``cond_proj``: a
    conditioning vector (a full LCM model's guidance embedding) projected
    onto the sinusoid and added to it before ``linear_1``."""

    def __init__(self, in_dim: int, dim: int, cond_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)
        if cond_dim is not None:  # last, so the other weights' random init is unchanged
            self.cond_proj = nn.Linear(cond_dim, in_dim, bias=False)

    def forward(self, t_emb: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is not None:
            t_emb = t_emb + self.cond_proj(cond.to(t_emb.dtype))
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GroupNorm(nn.Module):
    """GroupNorm over the last (channel) axis with fp32 statistics and an
    optional fused SiLU; ``gcd(C, groups)`` groups when C does not divide.
    With grad mode on and an input or weight that requires grad,
    ``group_norm_silu`` runs it through ``GroupNormSiLUFn``, as
    ``flash_attention`` runs attention through ``FlashAttentionFn``."""

    par = None

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        par = self.par
        if par is not None and par.n_seq > 1:  # statistics over every rank's rows
            return group_norm_silu_split(x, self.weight, self.bias, self.num_groups, self.eps,
                                         self.silu, par.seq_group)
        return group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)


class RMSNorm(nn.Module):
    """RMS norm over the last axis, no mean and no bias (T5's layer norm,
    the MMDiT's q/k norms): ``x * (rsqrt(mean(x^2) + eps) * weight)`` in
    fp32, cast to x's dtype, as the JAX package's ``nn.RMSNorm``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * (mul * self.weight.float())).to(x.dtype)


class ResnetBlock(_Quantizable):
    """GN+SiLU -> conv3x3 -> (+time) -> GN+SiLU -> conv3x3, plus the skip.
    ``temb_dim=None`` drops the time projection (the VAE's resnets).
    ``allow_quant``: the two 3x3 convs run int8 under the conv modes (the
    VAE passes False); the 1x1 shortcut never does.

    Under ``model`` (``tp_shard_``; a UNet's or ControlNet's resnet, one
    with ``time_emb_proj``) ``conv1`` keeps the rank's output channels
    (``tp``), the time projection's output is cut to them, ``norm2`` runs
    their ``G / n_model`` groups and ``conv2`` sums its partials across
    the axis; ``norm1``, the shortcut and the skip see the whole x.  The
    split branch's inputs (``norm1``'s output and the time projection's)
    enter through ``model_entry``, so their gradients sum over the axis."""

    tp: Optional[slice] = None

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 eps: float = 1e-5, allow_quant: bool = True):
        super().__init__()
        self.allow_quant = allow_quant
        self.norm1 = GroupNorm(in_channels, eps=eps, silu=True)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels) if temb_dim is not None else None
        self.norm2 = GroupNorm(out_channels, eps=eps, silu=True)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.time_emb_proj is None:
            return {}  # the VAE's resnets run whole
        C = self.conv1.out_channels
        G = resolve_groups(C, self.norm2.num_groups)
        if C % count or G % count:
            # gcd(C / n, G) groups would change the statistics: refuse instead.
            raise ValueError(f"mesh_model {count} must divide a resnet's {C} channels and "
                             f"its {G} GroupNorm groups")
        k = C // count
        self.tp = slice(index * k, (index + 1) * k)
        cuts = {f"{name}.{attr}": keep_slice_(getattr(self, name), attr, dim, index, count)
                for name, attr, dim in (("conv1", "weight", 0), ("conv1", "bias", 0),
                                        ("norm2", "weight", 0), ("norm2", "bias", 0),
                                        ("conv2", "weight", 1))}
        self.norm2.num_groups = G // count
        return cuts

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        if self.tp is not None:
            h = distributed.model_entry(h, self.par.model_group)
        h = self._conv(self.conv1, h)
        if t_emb is not None:
            temb = self.time_emb_proj(F.silu(t_emb))
            if self.tp is not None:
                temb = distributed.model_entry(temb, self.par.model_group)[:, self.tp]
            h = h + temb[:, None, None, :]
        h = self._conv(self.conv2, self.norm2(h), reduce=self.tp is not None)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x)
        return x + h


class Attention(_Quantizable):
    """Multi-head attention over [B, N, C] with an optional cross context;
    bias-free q/k/v projections, biased output projection.

    ``fused_qkv`` (the JAX package's ``SDBL_FUSED_QKV=1`` tree, diffusers'
    ``fuse_qkv_projections`` names): a self-attention (no ``context_dim``)
    projects through one ``to_qkv`` [3 * inner, query_dim], a
    cross-attention through ``to_q`` and one ``to_kv`` [2 * inner,
    context_dim]; q, k and v are views of the one output, which the
    attention kernels read through their strides without a copy.

    IP-Adapter (``add_ip``): the decoupled ``to_k_ip``/``to_v_ip``
    projections of the image-prompt tokens; given ``ip_context`` [B, P, Dc]
    a second attention over them shares the queries, and its output times
    ``ip_scale`` (a tensor, so that a CUDA graph reads it at each replay)
    is added before ``to_out``.

    Under ``model`` (``tp_shard_``, where the axis divides the heads) the
    rank keeps ``num_heads / n_model`` heads of every q/k/v projection (of
    each of q, k and v in a fused one) and ``to_out`` sums its partials
    across the axis.  Under ``seq`` a self-attention runs the rank's
    queries against K and V gathered along the axis in rank order (the
    image's row order); a cross-attention's context is whole on every
    rank."""

    split = False

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, fused_qkv: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.fused_qkv = bool(fused_qkv)
        if not self.fused_qkv:
            self.to_q = nn.Linear(query_dim, inner, bias=False)
            self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
            self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        elif context_dim is None:
            self.to_qkv = nn.Linear(query_dim, 3 * inner, bias=False)
        else:
            self.to_q = nn.Linear(query_dim, inner, bias=False)
            self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def add_ip(self) -> None:
        """Add the IP-Adapter projections (from the cross context's width),
        in the module's dtype and device; their weights are to be loaded."""
        w = (self.to_kv if self.fused_qkv else self.to_k).weight
        out = w.shape[0] // (2 if self.fused_qkv else 1)
        for name in ("to_k_ip", "to_v_ip"):
            if not hasattr(self, name):
                setattr(self, name, nn.Linear(w.shape[1], out, bias=False, device=w.device,
                                              dtype=w.dtype).requires_grad_(False))

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.num_heads % count:
            return {}  # e.g. SD-2.x's 5-head level at n_model 2: whole weights, unsplit
        # (projection, sections stacked in its rows): a fused one is cut a
        # section at a time, so the rank keeps its heads of q, of k and of v.
        sections = {"to_qkv": 3, "to_kv": 2}
        names = [(n, sections.get(n, 1)) for n in ("to_q", "to_k", "to_v", "to_qkv", "to_kv",
                                                   "to_k_ip", "to_v_ip") if hasattr(self, n)]
        cuts = {f"{n}.weight": keep_slice_(getattr(self, n), "weight", 0, index, count, halves)
                for n, halves in names}
        cuts["to_out.0.weight"] = keep_slice_(self.to_out[0], "weight", 1, index, count)
        self.num_heads //= count
        self.split = True
        return cuts

    def _qkv(self, x: torch.Tensor, context: Optional[torch.Tensor]):
        """q [B, N, I], k and v [B, M, I]: views of one output where the
        projections are fused."""
        inner = self.num_heads * self.head_dim
        if not self.fused_qkv:
            ctx = x if context is None else context
            return (self._proj(self.to_q, x), self._proj(self.to_k, ctx),
                    self._proj(self.to_v, ctx))
        if context is None:
            return self._proj(self.to_qkv, x).split(inner, dim=-1)
        return (self._proj(self.to_q, x), *self._proj(self.to_kv, context).split(inner, dim=-1))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, ip_context: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None, gather: bool = True) -> torch.Tensor:
        """``gather`` False: a self-attention over tokens that are already
        the whole map's on every rank (Token Merging under ``seq``)."""
        par = self.par
        if self.split:  # the rank's heads: the inputs' gradients sum over model
            x, context, ip_context = (None if t is None else
                                      distributed.model_entry(t, par.model_group)
                                      for t in (x, context, ip_context))
        B, N, _ = x.shape
        q, k, v = self._qkv(x, context)
        q = q.view(B, N, self.num_heads, self.head_dim)
        if context is None and gather and par is not None and par.n_seq > 1:
            k, v = distributed.all_gather_seq(torch.cat([k, v], dim=-1), 1,
                                              par.seq_group).chunk(2, dim=-1)
        M = k.shape[1]
        k = k.view(B, M, self.num_heads, self.head_dim)
        v = v.view(B, M, self.num_heads, self.head_dim)
        o = dot_product_attention(q, k, v, mask=mask).reshape(B, N, -1)
        if ip_context is not None:
            P = ip_context.shape[1]
            k_ip = self._proj(self.to_k_ip, ip_context).view(B, P, self.num_heads, self.head_dim)
            v_ip = self._proj(self.to_v_ip, ip_context).view(B, P, self.num_heads, self.head_dim)
            o_ip = dot_product_attention(q, k_ip, v_ip)
            o = o + ip_scale.to(o.dtype) * o_ip.reshape(B, N, -1)
        if self.split:
            return self._proj_reduce(self.to_out[0], o)
        return self._proj(self.to_out[0], o)


class _GEGLU(_Quantizable):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self._proj(self.proj, x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU, as diffusers' GEGLU


class GEGLUFeedForward(_Quantizable):
    """GEGLU feed-forward with 4x widening (diffusers ``ff.net.{0,2}``).
    Under ``model`` a rank keeps its hidden units: the same rows of both
    halves of ``net.0.proj``'s ``[h ; gate]`` and the matching input
    columns of ``net.2``, which sums its partials across the axis."""

    split = False

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.net[2].weight.shape[1] % count:
            return {}
        cuts = {f"net.0.proj.{attr}": keep_slice_(self.net[0].proj, attr, 0, index, count,
                                                  halves=2) for attr in ("weight", "bias")}
        cuts["net.2.weight"] = keep_slice_(self.net[2], "weight", 1, index, count)
        self.split = True
        return cuts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split:
            h = self.net[0](distributed.model_entry(x, self.par.model_group))
            return self._proj_reduce(self.net[2], h)
        return self._proj(self.net[2], self.net[0](x))


def tome_attend(attend, x: torch.Tensor, norm, tome, hw, dst: Optional[torch.Tensor],
                cache: Optional[dict], par=None):
    """Token Merging around a self-attention: ``x`` (a block's input, the
    similarity metric) matched on the ``hw`` token map
    (``ops.tome.shared_matching``), ``norm(x)`` merged, ``attend`` run on
    the merged tokens, and the first of the pair it returns unmerged; the
    second passes as it is.  Under ``seq`` (``par.n_seq > 1``) ``x`` is
    this rank's rows: the map's tokens are gathered along the axis first,
    every rank matches, merges and attends over the whole map as one
    process does (``attend`` gathers nothing more), and keeps its own rows
    of the unmerged output."""
    seq = par is not None and par.n_seq > 1
    whole = distributed.all_gather_seq(x, 1, par.seq_group) if seq else x
    merge, unmerge = shared_matching(whole, tome, hw, dst, cache)
    out, rest = attend(merge(norm(whole)))
    out = unmerge(out)
    if seq:
        n = x.shape[1]
        out = out[:, par.seq_index * n:(par.seq_index + 1) * n]
    return out, rest


class TransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, pre-norm residuals.

    With ``tome`` (a ``TomeConfig``), Token Merging around the
    self-attention: the block's input is the similarity metric, ``norm1(x)``
    is merged, the attention runs on the merged tokens and its output is
    unmerged.  ``tome_hw`` is the token map's (H, W), ``tome_dst`` its
    destinations (None: each cell's top-left token).  ``tome_cache`` (one
    dict per UNet call) shares one matching per (H, W, batch) among the
    blocks when ``tome.share``.  Under ``seq`` the block's tokens are
    gathered along the axis first (``tome_hw`` is the whole map's): every
    rank matches, merges and attends over the whole map, as one process
    does, and keeps its own rows of the unmerged output.

    ``cfg_tile`` (the CFG shared prefix): ``x`` is the single latent copy
    [B, N, C] and ``context`` the CFG-doubled [2B, T, C]; the block runs
    its self-attention at B and tiles x to 2B right before the
    cross-attention, where the two halves first differ.  A matching built
    at B serves the 2B blocks after it (``ops.tome.shared_matching``).
    ``fused_qkv``: both attentions' fused projections."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int,
                 fused_qkv: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, fused_qkv=fused_qkv)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim=context_dim,
                               fused_qkv=fused_qkv)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, tome=None, tome_hw=None,
                tome_dst: Optional[torch.Tensor] = None,
                tome_cache: Optional[dict] = None, ip_context: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None, cfg_tile: bool = False) -> torch.Tensor:
        if tome is None:
            x = x + self.attn1(self.norm1(x))
        else:
            x = x + tome_attend(lambda t: (self.attn1(t, gather=False), None), x, self.norm1,
                                tome, tome_hw, tome_dst, tome_cache,
                                getattr(self, "par", None))[0]
        if cfg_tile:
            x = torch.cat([x, x])
        x = x + self.attn2(self.norm2(x), context=context, ip_context=ip_context,
                           ip_scale=ip_scale)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(_Quantizable):
    """Transformer2D over a [B, H, W, C] map: GN -> proj_in -> blocks ->
    proj_out, plus the residual; ``ip_context``/``ip_scale`` go to each
    block's cross-attention (IP-Adapter).  proj_in/out are 1x1 convs (SD-1.5) or,
    with ``linear``, ``nn.Linear`` (SD-2.x, SDXL); the compute is the same.
    ``tome``/``tome_dst``/``tome_cache``: Token Merging in each block
    (``TransformerBlock``); ``tome_dst`` holds one row of destinations per
    block.  A map that the cells do not tile (H % sy or W % sx) runs
    without it.  ``cfg_tile`` (the CFG shared prefix's tile point): ``x``
    is the single latent copy [B, ...] and ``context`` [2B, ...]; block 0
    tiles to 2B before its cross-attention, and so does the residual
    (``TransformerBlock``).  ``fused_qkv``: the blocks' fused q/k/v
    projections."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, linear: bool = False, fused_qkv: bool = False):
        super().__init__()
        proj = (lambda: nn.Linear(channels, channels)) if linear else (
            lambda: nn.Conv2d(channels, channels, 1))
        self.norm = GroupNorm(channels, eps=1e-6)  # diffusers Transformer2DModel eps
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, num_heads, head_dim, context_dim, fused_qkv)
             for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor, tome=None,
                tome_dst: Optional[torch.Tensor] = None,
                tome_cache: Optional[dict] = None, ip_context: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None, cfg_tile: bool = False) -> torch.Tensor:
        B, H, W, C = x.shape
        H_all = H * (1 if self.par is None else self.par.n_seq)  # ToMe's map: the whole height
        if tome is not None and (H_all % tome.sy or W % tome.sx):
            tome = None
        h = self.norm(x).reshape(B, H * W, C)
        h = self._proj(self.proj_in, h)
        ip = dict(ip_context=ip_context, ip_scale=ip_scale)
        for i, block in enumerate(self.transformer_blocks):
            tile = cfg_tile and i == 0
            if tome is None:
                h = block(h, context, **ip, cfg_tile=tile)
            else:
                dst = None if tome_dst is None else tome_dst[i, :tome.n_dst(H_all, W)]
                h = block(h, context, tome, (H_all, W), dst, tome_cache, **ip, cfg_tile=tile)
        if cfg_tile:
            x = torch.cat([x, x])
        h = self._proj(self.proj_out, h)
        return h.reshape(x.shape) + x


class Level(nn.Module):
    """One diffusers down/up/mid block: ``resnets``, ``attentions`` and a
    resampler list, each present only where the geometry has it."""

    def __init__(self, resnets, attentions=(), resamplers=(), resampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resamplers:
            setattr(self, resampler_name, nn.ModuleList(resamplers))


class Downsample(_Quantizable):
    """Strided 3x3 conv.  Symmetric padding 1 (the UNet's downsamplers), or
    with ``asymmetric_pad`` one zero row and column at the bottom and right
    only (the VAE encoder's: diffusers' ``Downsample2D`` with padding 0 after
    ``F.pad(x, (0, 1, 0, 1))``).  ``allow_quant``: int8 under the conv
    modes (only the UNet's pass True)."""

    def __init__(self, channels: int, asymmetric_pad: bool = False, allow_quant: bool = False):
        super().__init__()
        self.allow_quant = allow_quant
        self.padding = ((0, 1), (0, 1)) if asymmetric_pad else ((1, 1), (1, 1))
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(self.conv, x, self.padding)


class Upsample(_Quantizable):
    """Nearest 2x resize + 3x3 conv; ``allow_quant`` as in Downsample.
    Under ``seq`` the halo row from each neighbour is taken before the
    resize, so one row crosses instead of two."""

    def __init__(self, channels: int, allow_quant: bool = False):
        super().__init__()
        self.allow_quant = allow_quant
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        par = self.par
        halo = par is not None and par.n_seq > 1
        if halo:
            x = distributed.halo_exchange(x, 1, 1, par.seq_group)
        B, H, W, C = x.shape
        x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
        if halo:  # one resized row of each halo is the conv's padding
            return self._conv(self.conv, x[:, 1:-1], ((0, 0), (1, 1)))
        return self._conv(self.conv, x)


class AttnBlock2D(Attention):
    """Single-head spatial self-attention of the VAE mid block (diffusers
    names: ``group_norm``, ``to_q``/``to_k``/``to_v``, ``to_out.0``; with
    ``fused_qkv`` one ``to_qkv``, as the JAX VAE's attention fuses).  Its
    D = 512 head takes the plain path either way."""

    def __init__(self, channels: int, num_heads: int = 1, fused_qkv: bool = False):
        super().__init__(channels, num_heads, channels // num_heads, fused_qkv=fused_qkv)
        self.group_norm = GroupNorm(channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = super().forward(self.group_norm(x).reshape(B, H * W, C))
        return x + h.reshape(B, H, W, C)
