"""MMDiT, the SD3-class multimodal diffusion transformer, in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/mmdit.py`` (Esser et
al. 2024, as shipped by SD3-medium).  Two token streams, the patchified
image latents and the text context, each with its own projections and
AdaLN-zero modulation, attend jointly (one attention over the image
tokens followed by the context tokens) in every block.  The joint
attention goes through ``ops.attention.dot_product_attention``: the bf16
wgmma kernel on the card at N = hp * wp + T tokens (4096 + 77 at 1024^2).

The call signature is the UNet's (``models/unet.py``), so the engine's
loop drives it unchanged: ``forward(sample [B, h, w, C], timesteps [B]
(sigma * 1000, floats), context [B, T, joint_attention_dim], cache,
tome_dst, text_embeds [B, pooled], time_ids)``; ``time_ids`` is accepted
and ignored (flow models carry no size conditioning).  The engine's
features map onto it:

* DeepCache is the trunk-delta cache: blocks ``0..b-1`` always run; a full
  call with ``return_cache`` also returns the deep blocks' residual delta
  ``x_out - x_b`` ([B, hp * wp, hidden]), which a cached call adds to the
  output of its blocks ``0..b-1`` (b = ``cache_branch_id``).
* Token Merging (DiT-ToMe) merges image tokens around each block's joint
  attention; the text stream never merges.  The matching is built on the
  block's input image stream; with ``tome.share`` block 0's serves every
  block.  The call's ToMe slots are its blocks (:meth:`MMDiT.tome_slots`),
  each slot's destinations a row of ``tome_dst``.  A patch grid that the
  cells do not tile runs without merging.
* Int8 W8A8 (``quant_mode``, ``ops/quant.py``) quantizes the projections
  that the JAX package's ``projection_dense`` covers: the patch embedding
  (as the dense over (ph, pw, c) rows it is), q/k/v and the added q/k/v,
  both output projections, both feed-forward layers and ``proj_out``.  The
  AdaLN linears, the two embedder MLPs and ``context_embedder`` stay exact.
  There is no conv to quantize, so ``int8_conv_only`` changes nothing.

Parameter names are diffusers' ``SD3Transformer2DModel``'s; the fixed
sincos table (diffusers' ``pos_embed.pos_embed`` buffer) is recomputed,
as the JAX package does, and kept out of the state dict.

Split execution (ROADMAP A9; ``parallel.mesh.place_module``): under
``model`` each joint attention keeps the rank's heads of both streams'
q/k/v (their per-head RMS norms stay local) and both feed-forwards their
hidden units (gelu-tanh is not gated, so ``net.0.proj`` splits plainly);
``to_out.0``, ``to_add_out`` and ``ff*.net.2`` sum their partials across
the axis in fp32, the bias added once (int8: the whole rows' scales,
the int32 partials summed).  The AdaLN modulations, the embedders and
``proj_out`` run whole.  Under ``seq`` a rank holds the image tokens of
its patch rows (the sincos table's rows offset by the rank), the context
stream is whole on every rank, and each joint attention gathers the image
K and V along the axis in rank order; with DiT-ToMe a block gathers its
image tokens first and matches, merges and attends over the whole patch
grid, keeping its own rows.  Training under ``model`` runs backward
through the split streams (``distributed.model_entry`` and
``all_reduce_sum``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import (
    RMSNorm,
    TimestepEmbedMLP,
    _Quantizable,
    keep_slice_,
    timestep_embedding,
    tome_attend,
)
from sonicdiffusionbayeslab_torch.ops import quant
from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention
from sonicdiffusionbayeslab_torch.parallel import distributed

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    depth: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096  # context token width before context_embedder
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192  # the sincos table's grid, center-cropped per call
    sample_size: int = 128  # the latent grid the table is scaled for
    time_embed_channels: int = 256
    qk_norm: bool = False  # RMS norms on q and k (the SD3.5 family)

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def sd3_medium(cls) -> "MMDiTConfig":
        """stabilityai/stable-diffusion-3-medium transformer/config.json."""
        return cls()

    @classmethod
    def tiny(cls) -> "MMDiTConfig":
        """CPU-sized geometry on the same code path; its context (16 + 16)
        matches ``SDXLTextConfigs.tiny()``, padded to 40."""
        return cls(depth=2, num_heads=2, head_dim=8, joint_attention_dim=40,
                   pooled_projection_dim=32, pos_embed_max_size=24, sample_size=8,
                   time_embed_channels=32)


def sincos_pos_embed_2d(embed_dim: int, grid_size: int, base_size: int,
                        interpolation_scale: float = 1.0, rows=None, cols=None) -> np.ndarray:
    """[grid * grid, embed_dim] fp32 table, diffusers'
    ``get_2d_sincos_pos_embed`` in float64 (w varies fastest, sin halves
    first); ``rows``/``cols`` (slices) keep only those grid positions, with
    the same bits (every entry is computed on its own)."""
    pos = np.arange(grid_size, dtype=np.float64) / (grid_size / base_size) / interpolation_scale
    grid_h, grid_w = pos[rows or slice(None)], pos[cols or slice(None)]
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, len(grid_h), len(grid_w)])

    def emb_1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([emb_1d(embed_dim // 2, grid[0]), emb_1d(embed_dim // 2, grid[1])],
                         axis=1)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def cropped_pos_embed(cfg: MMDiTConfig, h: int, w: int) -> np.ndarray:
    """The table center-cropped to an h x w patch grid, [h * w, hidden]
    (diffusers' ``PatchEmbed.cropped_pos_embed``)."""
    m = cfg.pos_embed_max_size
    if h > m or w > m:
        raise ValueError(f"latent grid {h}x{w} exceeds pos_embed_max_size {m}")
    top, left = (m - h) // 2, (m - w) // 2
    out = sincos_pos_embed_2d(cfg.hidden_size, m, cfg.sample_size // cfg.patch_size,
                              rows=slice(top, top + h), cols=slice(left, left + w))
    out.flags.writeable = False
    return out


class AdaLNZero(nn.Module):
    """silu(c) -> Linear(n_chunks * dim), split into the chunks: diffusers'
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp), or
    (scale, shift) for the 2-chunk ``norm_out`` and final context norm."""

    def __init__(self, dim: int, n_chunks: int):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = nn.Linear(dim, n_chunks * dim)

    def forward(self, c: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.linear(F.silu(c)).chunk(self.n_chunks, dim=-1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)


class GELUTanhFeedForward(_Quantizable):
    """Linear(4x) -> gelu(tanh) -> Linear (diffusers ``FeedForward`` with
    ``gelu-approximate``: ``net.0.proj``, ``net.2``); under ``model`` the
    rank's hidden units."""

    split = False

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.net[2].weight.shape[1] % count:
            return {}
        cuts = {f"net.0.proj.{attr}": keep_slice_(self.net[0].proj, attr, 0, index, count)
                for attr in ("weight", "bias")}
        cuts["net.2.weight"] = keep_slice_(self.net[2], "weight", 1, index, count)
        self.split = True
        return cuts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split:
            x = distributed.model_entry(x, self.par.model_group)
        h = F.gelu(self._proj(self.net[0].proj, x), approximate="tanh")
        if self.split:
            return self._proj_reduce(self.net[2], h)
        return self._proj(self.net[2], h)


class JointAttention(_Quantizable):
    """The projections of one joint block (diffusers' ``attn``): q/k/v of
    each stream, ``to_out.0`` for the image stream and ``to_add_out`` for
    the context (absent in the final, context_pre_only block).  Under
    ``model`` the rank's heads; under ``seq`` the image K and V gathered
    along the axis."""

    split = False
    _HEADS = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_pre_only: bool,
                 qk_norm: bool):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, nn.Linear(dim, inner))
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(inner, dim)
        self.qk_norm = qk_norm
        if qk_norm:
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, RMSNorm(head_dim, eps=1e-6))

    def tp_shard_(self, index: int, count: int) -> dict:
        if self.num_heads % count:
            return {}
        cuts = {f"{name}.{attr}": keep_slice_(getattr(self, name), attr, 0, index, count)
                for name in self._HEADS for attr in ("weight", "bias")}
        outs = {"to_out.0": self.to_out[0], "to_add_out": getattr(self, "to_add_out", None)}
        for name, layer in outs.items():
            if layer is not None:
                cuts[f"{name}.weight"] = keep_slice_(layer, "weight", 1, index, count)
        self.num_heads //= count
        self.split = True
        return cuts

    def project(self, layer: nn.Module, o: torch.Tensor) -> torch.Tensor:
        """An output projection (``to_out.0``, ``to_add_out``) of the
        attention's output: row-parallel under ``model``."""
        if self.split:
            return self._proj_reduce(layer, o)
        return self._proj(layer, o)

    def forward(self, img: torch.Tensor, ctx: torch.Tensor, gather: bool = True):
        """(image [B, N, C], context [B, T, C]) -> the attention's outputs
        of each stream before their output projections, [B, N, inner] and
        [B, T, inner]; image tokens first in the joint sequence.
        ``gather`` False: image tokens that are already the whole map's on
        every rank (Token Merging under ``seq``)."""
        par = self.par
        if self.split:  # the rank's heads: the inputs' gradients sum over model
            img = distributed.model_entry(img, par.model_group)
            ctx = distributed.model_entry(ctx, par.model_group)
        B, N, _ = img.shape
        T = ctx.shape[1]
        H, D = self.num_heads, self.head_dim

        def heads(layer, x):
            return self._proj(layer, x).view(B, x.shape[1], H, D)

        q_i, k_i, v_i = heads(self.to_q, img), heads(self.to_k, img), heads(self.to_v, img)
        q_c, k_c = heads(self.add_q_proj, ctx), heads(self.add_k_proj, ctx)
        v_c = heads(self.add_v_proj, ctx)
        if self.qk_norm:
            q_i, k_i = self.norm_q(q_i), self.norm_k(k_i)
            q_c, k_c = self.norm_added_q(q_c), self.norm_added_k(k_c)
        if gather and par is not None and par.n_seq > 1:  # every rank's image keys, in row order
            kv = distributed.all_gather_seq(torch.cat([k_i, v_i], dim=-1), 1, par.seq_group)
            k_i, v_i = kv.chunk(2, dim=-1)
        o = dot_product_attention(torch.cat([q_i, q_c], dim=1), torch.cat([k_i, k_c], dim=1),
                                  torch.cat([v_i, v_c], dim=1)).reshape(B, N + T, H * D)
        return o[:, :N], o[:, N:]


class MMDiTBlock(_Quantizable):
    """One joint block: per-stream AdaLN-zero, joint attention over [image
    ++ context], per-stream gated residuals and feed-forward.  The final
    block (``context_pre_only``) feeds the context's k/v into the attention
    but returns no context: a 2-chunk (scale, shift) context norm and no
    ``to_add_out``, ``ff_context``."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        dim = cfg.hidden_size
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLNZero(dim, 6)
        self.norm1_context = AdaLNZero(dim, 2 if context_pre_only else 6)
        self.attn = JointAttention(dim, cfg.num_heads, cfg.head_dim, context_pre_only,
                                   cfg.qk_norm)
        self.ff = GELUTanhFeedForward(dim)
        if not context_pre_only:
            self.ff_context = GELUTanhFeedForward(dim)

    def forward(self, img: torch.Tensor, ctx: torch.Tensor, c: torch.Tensor, tome=None,
                tome_hw=None, tome_dst: Optional[torch.Tensor] = None,
                tome_cache: Optional[dict] = None):
        i_mod = self.norm1(c)
        c_mod = self.norm1_context(c)
        if self.context_pre_only:
            ctx_n = _modulate(_ln(ctx), c_mod[1], c_mod[0])  # (scale, shift)
        else:
            ctx_n = _modulate(_ln(ctx), c_mod[0], c_mod[1])

        def norm(t):
            return _modulate(_ln(t), i_mod[0], i_mod[1])

        def attend(t, gather=True):
            o, o_ctx = self.attn(t, ctx_n, gather=gather)
            return self.attn.project(self.attn.to_out[0], o), o_ctx

        if tome is None:
            o_img, o_ctx = attend(norm(img))
        else:
            o_img, o_ctx = tome_attend(lambda t: attend(t, gather=False), img, norm, tome,
                                       tome_hw, tome_dst, tome_cache, self.par)
        img = img + i_mod[2][:, None, :] * o_img
        img_m = _modulate(_ln(img), i_mod[3], i_mod[4])
        img = img + i_mod[5][:, None, :] * self.ff(img_m)
        if self.context_pre_only:
            return img, None
        ctx = ctx + c_mod[2][:, None, :] * self.attn.project(self.attn.to_add_out, o_ctx)
        ctx_m = _modulate(_ln(ctx), c_mod[3], c_mod[4])
        return img, ctx + c_mod[5][:, None, :] * self.ff_context(ctx_m)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, p, stride=p)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.timestep_embedder = TimestepEmbedMLP(cfg.time_embed_channels, cfg.hidden_size)
        self.text_embedder = TimestepEmbedMLP(cfg.pooled_projection_dim, cfg.hidden_size)


class MMDiT(_Quantizable):
    """The whole transformer: NHWC latents in, fp32 velocity out.  Under
    ``seq`` the sample holds the rank's rows of the latent height, a
    multiple of ``seq_multiple`` (the patch size) on every rank."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        cfg = self.config = config
        dim = cfg.hidden_size
        self.pos_embed = _PatchEmbed(cfg)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [MMDiTBlock(cfg, context_pre_only=(i == cfg.depth - 1)) for i in range(cfg.depth)])
        self.norm_out = AdaLNZero(dim, 2)
        self.proj_out = nn.Linear(dim, cfg.patch_size ** 2 * cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    @property
    def seq_multiple(self) -> int:
        return self.config.patch_size

    def _pos(self, h: int, w: int, device, dtype) -> torch.Tensor:
        """The cropped sincos table on the device, made once per (grid,
        device, dtype) and kept (a graph capture then copies nothing from
        the host)."""
        cache = self.__dict__.setdefault("_pos_tables", {})
        key = (h, w, str(device), dtype)
        if key not in cache:
            cache[key] = torch.tensor(cropped_pos_embed(self.config, h, w),
                                         device=device).to(dtype)
        return cache[key]

    def _patch_proj(self, tokens: torch.Tensor) -> torch.Tensor:
        """The patch embedding on [B, hp * wp, p * p * C] rows in (ph, pw,
        c) order: the conv as the dense it is."""
        conv = self.pos_embed.proj
        if quant.dense_enabled(self.quant_mode):
            wq = quant.cached_weight_q(conv, quant.conv_weight_rows)
            return quant.int8_dense(tokens, quant.conv_weight_rows(conv.weight), conv.bias,
                                    weight_q=wq)
        return F.linear(tokens, quant.conv_weight_rows(conv.weight), conv.bias)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cache: Optional[torch.Tensor] = None,
                tome_dst: Optional[torch.Tensor] = None,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None, return_cache: bool = False,
                cache_branch_id: int = 0, tome=None,
                timestep_cond: Optional[torch.Tensor] = None):
        """sample [B, h, w, C], timesteps [B] or scalar (sigma * 1000),
        context [B, T, joint_attention_dim], ``text_embeds`` [B,
        pooled_projection_dim] (required) -> velocity [B, h, w, C] fp32; with
        ``return_cache`` also the trunk delta.  ``tome_dst`` [slots, D]: row
        k holds ToMe slot k's (block k's) destinations."""
        cfg = self.config
        dt = self.dtype
        if timestep_cond is not None:
            raise NotImplementedError("MMDiT has no w-embedding conditioning")
        if text_embeds is None:
            raise ValueError("MMDiT requires added_cond with 'text_embeds': the pooled "
                             f"[B, {cfg.pooled_projection_dim}] SD3 conditioning vector")
        B, h, w, C = sample.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"latent grid {h}x{w} not divisible by patch {p}")
        hp, wp = h // p, w // p
        if encoder_hidden_states.shape[-1] != cfg.joint_attention_dim:
            raise ValueError(f"context dim {encoder_hidden_states.shape[-1]} != "
                             f"joint_attention_dim {cfg.joint_attention_dim} (pad as the "
                             f"pipeline does)")
        branch = int(cache_branch_id)
        if (cache is not None or return_cache) and not 0 <= branch < cfg.depth:
            raise ValueError(f"cache_branch_id {branch} out of range [0, {cfg.depth}) "
                             f"(number of always-fresh leading blocks)")
        if cache is not None and return_cache:
            raise ValueError("cache and return_cache are exclusive (a step either replays "
                             "the trunk or records it)")
        par = self.par
        n_seq = 1 if par is None else par.n_seq
        if tome is not None and (hp * n_seq % tome.sy or wp % tome.sx):
            tome = None  # the cells do not tile this patch grid
        if tome is not None and tome.rand and tome_dst is None:
            raise ValueError("tome.rand needs tome_dst, each block's destinations "
                             "(utils/rng.py::tome_destinations)")

        x = sample.to(dt).reshape(B, hp, p, wp, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self._patch_proj(x.reshape(B, hp * wp, p * p * C))
        pos = self._pos(hp * n_seq, wp, x.device, dt)
        if n_seq > 1:  # the table's rows of this rank's patch rows
            pos = pos[par.seq_index * hp * wp:(par.seq_index + 1) * hp * wp]
        x = x + pos[None]

        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        t_emb = timestep_embedding(timesteps, cfg.time_embed_channels)
        emb = self.time_text_embed
        c = emb.timestep_embedder(t_emb.to(dt)) + emb.text_embedder(text_embeds.to(dt))
        ctx = self.context_embedder(encoder_hidden_states.to(dt))

        tome_cache = {}

        def block(i, x, ctx):
            if tome is None:
                return self.transformer_blocks[i](x, ctx, c)
            dst = None if tome_dst is None else tome_dst[i, :tome.n_dst(hp * n_seq, wp)]
            return self.transformer_blocks[i](x, ctx, c, tome, (hp * n_seq, wp), dst, tome_cache)

        if cache is not None:
            for i in range(branch):
                x, ctx = block(i, x, ctx)
            x = x + cache.to(dt)
        else:
            x_b = x
            for i in range(cfg.depth):
                if i == branch:
                    x_b = x
                x, ctx = block(i, x, ctx)
            trunk_delta = x - x_b

        scale, shift = self.norm_out(c)
        x = self._proj(self.proj_out, _modulate(_ln(x), shift, scale))
        x = x.reshape(B, hp, wp, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        out = x.reshape(B, h, w, cfg.out_channels).float()
        return (out, trunk_delta) if return_cache else out

    def tome_slots(self, height: int, width: int, tome,
                   cache_branch_id: Optional[int] = None):
        """The ToMe slots of a call at a ``[*, height, width, *]`` sample: one
        ``(block, 0, hp, wp)`` for each block the call runs (all of them, or
        a cached call's first ``cache_branch_id``); none where the cells do
        not tile the patch grid."""
        p = self.config.patch_size
        hp, wp = height // p, width // p
        if hp % tome.sy or wp % tome.sx:
            return []
        n = self.config.depth if cache_branch_id is None else int(cache_branch_id)
        return [(i, 0, hp, wp) for i in range(n)]

    def cache_shape(self, height: int, width: int, cache_branch_id: int = 0):
        """Shape (without the batch) of the trunk delta of a ``[*, height,
        width, *]`` sample: one hidden-width row per image patch, whatever
        the split depth."""
        p = self.config.patch_size
        return ((height // p) * (width // p), self.config.hidden_size)
