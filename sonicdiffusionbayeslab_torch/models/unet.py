"""UNet2DCondition (SD-1.5 geometry) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/unet.py`` on the plain
text-to-image path (no SDXL added conditioning, DeepCache, ControlNet,
IP-Adapter, guidance embedding, CFG shared prefix or token merging).
Parameter names follow diffusers' ``UNet2DConditionModel``; activations
are [B, H, W, C] at the module's boundary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample [B, h, w, C_in], timesteps [B] or scalar, context [B, T, D]
        -> [B, h, w, C_out] fp32."""
        dt = self.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, self.config.block_out_channels[0])
        t_emb = self.time_embedding(t_emb.to(dt))
        ctx = encoder_hidden_states.to(dt)

        h = conv_nhwc(self.conv_in, sample.to(dt))
        skips = [h]
        for level in self.down_blocks:
            attns = getattr(level, "attentions", None)
            for j, res in enumerate(level.resnets):
                h = res(h, t_emb)
                if attns is not None:
                    h = attns[j](h, ctx)
                skips.append(h)
            for samp in getattr(level, "downsamplers", ()):
                h = samp(h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, t_emb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, t_emb)

        for level in self.up_blocks:
            attns = getattr(level, "attentions", None)
            for j, res in enumerate(level.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), t_emb)
                if attns is not None:
                    h = attns[j](h, ctx)
            for samp in getattr(level, "upsamplers", ()):
                h = samp(h)

        h = self.conv_norm_out(h)
        return conv_nhwc(self.conv_out, h).float()
