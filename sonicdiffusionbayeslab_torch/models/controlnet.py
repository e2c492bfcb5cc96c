"""ControlNet (Zhang et al. 2023) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/controlnet.py``, with
diffusers ``ControlNetModel``'s parameter names: a trainable copy of the
UNet's encoder (``conv_in``, ``time_embedding``, SDXL's ``add_embedding``,
``down_blocks``, ``mid_block``: ``unet.build_encoder``), plus

- ``controlnet_cond_embedding``: the control image [B, 8h, 8w, 3] in [0, 1]
  down to latent resolution through a SiLU conv stack, added to
  ``conv_in``'s output, and
- one zero-initialised 1x1 conv a skip state (``controlnet_down_blocks``)
  and one after the mid block (``controlnet_mid_block``), whose outputs,
  times the conditioning scale, are the residuals the UNet adds
  (``UNet2DCondition(control_residuals=...)``).

With its zero-initialised heads an untrained ControlNet changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import conv_nhwc, seq_conv
from sonicdiffusionbayeslab_torch.models.unet import (
    UNetConfig,
    build_encoder,
    encoder_levels,
    mid_level,
    time_embedding,
)

# diffusers ControlNetConditioningEmbedding's block_out_channels default.
COND_EMBED_CHANNELS = (16, 32, 96, 256)


class ConditioningEmbedding(nn.Module):
    """Control image [B, 8h, 8w, 3] -> [B, h, w, C0]: conv_in -> SiLU ->
    (conv -> SiLU -> stride-2 conv -> SiLU) x 3 -> conv_out (zero init)."""

    par = None  # under seq: the rank's rows of the control image, halo'd convs

    def __init__(self, out_channels: int, channels: Tuple[int, ...] = COND_EMBED_CHANNELS):
        super().__init__()
        self.conv_in = nn.Conv2d(3, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(nn.Conv2d(channels[i], channels[i], 3, padding=1))
            blocks.append(nn.Conv2d(channels[i], channels[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(seq_conv(self.conv_in, cond.to(self.conv_in.weight.dtype), self.par))
        for conv in self.blocks:
            h = F.silu(seq_conv(conv, h, self.par))
        return seq_conv(self.conv_out, h, self.par)


class ControlNet(nn.Module):
    """UNet-encoder copy, conditioning embedding and zero-conv heads;
    :meth:`zero_heads` zeroes what diffusers zero-initialises.  Placed on
    a mesh it splits as the UNet's encoder does; the 1x1 zero convs run
    whole on the whole (summed) skip states, and under ``seq`` the control
    image holds the rank's rows, so the residuals are the rank's rows.
    ``fused_qkv``: the encoder copy's fused q/k/v projections."""

    par = None

    def __init__(self, config: UNetConfig, fused_qkv: bool = False):
        super().__init__()
        # No guidance embedding: the JAX package's ControlNet has no cond_proj.
        cfg = self.config = dataclasses.replace(config, time_cond_proj_dim=None)
        self.fused_qkv = bool(fused_qkv)
        skip_ch = build_encoder(self, cfg, self.fused_qkv)
        self.controlnet_cond_embedding = ConditioningEmbedding(cfg.block_out_channels[0])
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skip_ch])
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)

    def heads(self):
        return (self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                self.controlnet_mid_block)

    @torch.no_grad()
    def zero_heads(self) -> "ControlNet":
        for conv in self.heads():
            conv.weight.zero_()
            conv.bias.zero_()
        return self

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cond: torch.Tensor,
                conditioning_scale: torch.Tensor, text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None):
        """latents [B, h, w, C_in], timesteps [B] or scalar, context [B, T,
        D], control image [B, 8h, 8w, 3] in [0, 1], the scale (a 0-dim
        tensor), SDXL's pooled embeddings and time_ids -> (down residuals,
        one a skip state, mid residual), each times the scale."""
        cfg = self.config
        dt = self.conv_in.weight.dtype
        t_emb = time_embedding(self, cfg, timesteps, text_embeds, time_ids, sample.shape[0])
        ctx = encoder_hidden_states.to(dt)
        h = seq_conv(self.conv_in, sample.to(dt), self.par) + self.controlnet_cond_embedding(cond)
        h, skips = encoder_levels(self, h, t_emb, lambda attn, lvl, x: attn(x, ctx),
                                  len(cfg.block_out_channels) - 1, True)
        h = mid_level(self, h, t_emb, lambda attn, lvl, x: attn(x, ctx))
        scale = conditioning_scale.to(dt)
        down = tuple(conv_nhwc(conv, s) * scale
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, conv_nhwc(self.controlnet_mid_block, h) * scale
