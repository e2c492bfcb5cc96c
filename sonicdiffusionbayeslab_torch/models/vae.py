"""AutoencoderKL decoder (SD VAE) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/vae.py``: ``Decoder``
and ``AutoencoderKL.decode`` (the encoder comes with img2img).  Geometry
(SD-1.5 vae/config.json, also SD-2.x's and SDXL's): 4 latent channels,
block_out_channels (128, 256, 512, 512), 2 layers per block, a mid
attention, scaling factor 0.18215 (SDXL's 0.13025); every norm uses eps
1e-6.  Parameter names follow diffusers'
``AutoencoderKL``; maps are [B, H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import (
    AttnBlock2D,
    GroupNorm,
    Level,
    ResnetBlock,
    Upsample,
    conv_nhwc,
)

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1)

    @classmethod
    def sd15(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        """SD's geometry, retrained for SDXL (scaling factor 0.13025,
        stable-diffusion-xl-base-1.0 vae/config.json)."""
        return cls(scaling_factor=0.13025)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        top = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, top, 3, padding=1)
        self.mid_block = Level([ResnetBlock(top, top, eps=EPS), ResnetBlock(top, top, eps=EPS)],
                               [AttnBlock2D(top)])
        ups, cur = [], top
        chans = list(reversed(cfg.block_out_channels))
        for i, ch in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cur, ch, eps=EPS))
                cur = ch
            samp = [Upsample(ch)] if i < len(chans) - 1 else []
            ups.append(Level(res, (), samp, "upsamplers"))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(cur, eps=EPS, silu=True)
        self.conv_out = nn.Conv2d(cur, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for level in self.up_blocks:
            for res in level.resnets:
                h = res(h)
            for samp in getattr(level, "upsamplers", ()):
                h = samp(h)
        return conv_nhwc(self.conv_out, self.conv_norm_out(h)).float()


class AutoencoderKL(nn.Module):
    """decode(z) -> image in [-1, 1]."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = (nn.Conv2d(config.latent_channels, config.latent_channels, 1)
                                if config.use_quant_conv else None)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, C] -> image [B, 8h, 8w, 3] in [-1, 1] (fp32):
        divide by the scaling factor, then post_quant_conv, then the decoder."""
        z = z / self.config.scaling_factor + self.config.shift_factor
        z = z.to(self.decoder.conv_in.weight.dtype)
        if self.post_quant_conv is not None:
            z = conv_nhwc(self.post_quant_conv, z)
        return self.decoder(z)

    forward = decode
