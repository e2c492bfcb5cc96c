"""UNet2DCondition (SD-1.5 geometry) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/unet.py`` on the
text-to-image path with its DeepCache split and Token Merging (no SDXL
added conditioning, ControlNet, IP-Adapter, guidance embedding or CFG
shared prefix).
Parameter names follow diffusers' ``UNet2DConditionModel``; activations
are [B, H, W, C] at the module's boundary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import (
    Downsample,
    GroupNorm,
    Level,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedMLP,
    Upsample,
    conv_nhwc,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 defaults (runwayml/stable-diffusion-v1-5 unet/config.json)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: int = 1
    num_attention_heads: int = 8
    cross_attention_dim: int = 768

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """2-level random-weight UNet for CPU tests."""
        return cls(block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention=(True, False), num_attention_heads=2,
                   cross_attention_dim=32)

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_out_channels
        n = len(chans)
        temb = chans[0] * 4
        heads = cfg.num_attention_heads

        def xfmr(ch):
            return SpatialTransformer(ch, heads, ch // heads, cfg.cross_attention_dim,
                                      depth=cfg.transformer_depth)

        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(chans[0], temb)

        skip_ch, cur = [chans[0]], chans[0]
        down = []
        for lvl, ch in enumerate(chans):
            res, att = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(cur, ch, temb))
                cur = ch
                if cfg.cross_attention[lvl]:
                    att.append(xfmr(ch))
                skip_ch.append(ch)
            samp = [Downsample(ch)] if lvl < n - 1 else []
            if samp:
                skip_ch.append(ch)
            down.append(Level(res, att, samp, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        mid = chans[-1]
        self.mid_block = Level([ResnetBlock(cur, mid, temb), ResnetBlock(mid, mid, temb)],
                               [xfmr(mid)])
        cur = mid

        up = []  # diffusers up_blocks[k] is level n - 1 - k
        for lvl in reversed(range(n)):
            ch = chans[lvl]
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cur + skip_ch.pop(), ch, temb))
                cur = ch
                if cfg.cross_attention[lvl]:
                    att.append(xfmr(ch))
            samp = [Upsample(ch)] if lvl > 0 else []
            up.append(Level(res, att, samp, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(chans[0], silu=True)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cache: Optional[torch.Tensor] = None,
                tome_dst: Optional[torch.Tensor] = None, return_cache: bool = False,
                cache_branch_id: int = 0, tome=None):
        """sample [B, h, w, C_in], timesteps [B] or scalar, context [B, T, D]
        -> [B, h, w, C_out] fp32.

        DeepCache: the shallow branch is down levels ``0..b`` and up levels
        ``b..0`` (b = ``cache_branch_id``); the deeper levels and the mid
        block are the trunk, whose output feeds up level b.  With
        ``return_cache`` a full call also returns that output; given
        ``cache`` (the trunk output of an earlier step, shaped
        ``[B, *cache_shape(h, w, b)]``) only the shallow branch runs.

        Token Merging: with ``tome`` (a ``TomeConfig``) every transformer
        block at a level whose downsample factor is at most
        ``tome.max_downsample`` merges tokens around its self-attention.
        Those blocks are this call's ToMe slots, counted in call order
        (:meth:`tome_slots`); ``tome_dst`` [slots, D] holds slot k's
        destinations in row k (the first ``n_dst`` entries of its map).
        ``tome.rand`` needs it; without ``rand`` each cell's top-left token
        is its destination."""
        dt = self.dtype
        cfg = self.config
        n = len(cfg.block_out_channels)
        branch = int(cache_branch_id)
        if not 0 <= branch < n:
            raise ValueError(f"cache_branch_id {branch} out of range [0, {n})")
        if tome is not None and tome.rand and tome_dst is None:
            raise ValueError("tome.rand needs tome_dst, each ToMe slot's destinations "
                             "(utils/rng.py::tome_destinations)")
        deep = cache is None
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        t_emb = self.time_embedding(t_emb.to(dt))
        ctx = encoder_hidden_states.to(dt)
        slot, tome_cache = 0, {}

        def xfmr(attn, lvl, h):
            nonlocal slot
            if tome is None or (1 << lvl) > tome.max_downsample:
                return attn(h, ctx)
            depth = len(attn.transformer_blocks)
            dst = None if tome_dst is None else tome_dst[slot:slot + depth]
            slot += depth
            return attn(h, ctx, tome, dst, tome_cache)

        h = conv_nhwc(self.conv_in, sample.to(dt))
        skips = [h]
        for lvl, level in enumerate(self.down_blocks):
            if lvl > branch and not deep:
                break
            attns = getattr(level, "attentions", None)
            for j, res in enumerate(level.resnets):
                h = res(h, t_emb)
                if attns is not None:
                    h = xfmr(attns[j], lvl, h)
                skips.append(h)
            # Level b's downsample feeds only the trunk.
            if deep or lvl < branch:
                for samp in getattr(level, "downsamplers", ()):
                    h = samp(h)
                    skips.append(h)

        # up_blocks[k] is level n - 1 - k.
        up = [(n - 1 - k, level) for k, level in enumerate(self.up_blocks)]
        if deep:
            h = self.mid_block.resnets[0](h, t_emb)
            h = xfmr(self.mid_block.attentions[0], n - 1, h)
            h = self.mid_block.resnets[1](h, t_emb)
            h = self._up(up[:n - 1 - branch], h, skips, t_emb, xfmr)
            deep_features = h
        else:
            deep_features = h = cache.to(dt)
        h = self._up(up[n - 1 - branch:], h, skips, t_emb, xfmr)

        h = self.conv_norm_out(h)
        out = conv_nhwc(self.conv_out, h).float()
        return (out, deep_features) if return_cache else out

    @staticmethod
    def _up(levels, h, skips, t_emb, xfmr):
        for lvl, level in levels:
            attns = getattr(level, "attentions", None)
            for j, res in enumerate(level.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), t_emb)
                if attns is not None:
                    h = xfmr(attns[j], lvl, h)
            for samp in getattr(level, "upsamplers", ()):
                h = samp(h)
        return h

    def tome_slots(self, height: int, width: int, tome,
                   cache_branch_id: Optional[int] = None):
        """The ToMe slots of a call at a ``[*, height, width, *]`` sample, in
        call order: ``(site, block, h, w)`` for each transformer block that
        merges tokens (``site`` counts the call's transformers that do, as
        the JAX package's keys do; ``h, w`` is the block's token map).  A
        full call, or DeepCache's shallow call at ``cache_branch_id``."""
        cfg = self.config
        n = len(cfg.block_out_channels)
        b = n - 1 if cache_branch_id is None else int(cache_branch_id)
        shapes = [(height, width)]
        for _ in range(n - 1):  # stride-2 convs with padding 1
            shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
        # (level, transformers): the down levels, the mid block (always a
        # transformer), the up levels.
        down = [(lvl, cfg.layers_per_block * cfg.cross_attention[lvl]) for lvl in range(b + 1)]
        mid = [(n - 1, 1)] if cache_branch_id is None else []
        up = [(lvl, (cfg.layers_per_block + 1) * cfg.cross_attention[lvl])
              for lvl in reversed(range(b + 1))]
        slots, site = [], 0
        for lvl, count in down + mid + up:
            for _ in range(count):
                if (1 << lvl) > tome.max_downsample:
                    continue
                slots += [(site, i) + shapes[lvl] for i in range(cfg.transformer_depth)]
                site += 1
        return slots

    def cache_shape(self, height: int, width: int, cache_branch_id: int = 0):
        """Shape (without the batch) of the trunk output a ``[*, height,
        width, *]`` sample gives: up level b's input, at height / 2^b with
        up level b + 1's width (the mid block's when b is the deepest)."""
        b = int(cache_branch_id)
        chans = self.config.block_out_channels
        return (height >> b, width >> b, chans[min(b + 1, len(chans) - 1)])
