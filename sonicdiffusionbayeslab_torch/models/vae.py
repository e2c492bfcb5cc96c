"""AutoencoderKL (SD VAE) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/vae.py``: ``Decoder``,
``Encoder`` and ``AutoencoderKL``'s ``decode``, ``encode`` and
``encode_sample``.  Its convs never quantize (``allow_quant=False``, as
the JAX package's VAE).  Geometry
(SD-1.5 vae/config.json, also SD-2.x's and SDXL's): 4 latent channels,
block_out_channels (128, 256, 512, 512), 2 layers per block, a mid
attention, scaling factor 0.18215 (SDXL's 0.13025; SD3's: 16 channels,
1.5305 and shift 0.0609, no quant convs); every norm uses eps 1e-6.  Parameter names follow diffusers'
``AutoencoderKL``; maps are [B, H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.layers import (
    AttnBlock2D,
    Downsample,
    GroupNorm,
    Level,
    ResnetBlock,
    Upsample,
    conv_nhwc,
)

EPS = 1e-6
# The logvar clip of diffusers' DiagonalGaussianDistribution.
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0
# Key prefixes of the encoder side of a VAE state dict.
ENCODER_KEYS = ("encoder.", "quant_conv.")


def _resnet(cin: int, cout: int) -> ResnetBlock:
    return ResnetBlock(cin, cout, eps=EPS, allow_quant=False)


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

    @classmethod
    def sd3(cls) -> "VAEConfig":
        """stable-diffusion-3-medium vae/config.json: 16-channel latents,
        scaling 1.5305, shift 0.0609, no (post_)quant convs."""
        return cls(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                   use_quant_conv=False)

    @classmethod
    def tiny16(cls) -> "VAEConfig":
        """The tiny geometry with SD3's 16-channel latent contract."""
        return cls(block_out_channels=(16, 32), layers_per_block=1, latent_channels=16,
                   scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, fused_qkv: bool = False):
        super().__init__()
        top = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, top, 3, padding=1)
        self.mid_block = Level([_resnet(top, top), _resnet(top, top)],
                               [AttnBlock2D(top, fused_qkv=fused_qkv)])
        ups, cur = [], top
        chans = list(reversed(cfg.block_out_channels))
        for i, ch in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(_resnet(cur, ch))
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


class Encoder(nn.Module):
    """Image [B, H, W, 3] -> moments [B, H/f, W/f, 2 * latent_channels] fp32
    (mean, then logvar; f = 2 ** (levels - 1)): conv_in, the down levels
    (each but the last ends in a stride-2 conv padded at the bottom and
    right only), the mid block with its attention, GN+SiLU, conv_out."""

    def __init__(self, cfg: VAEConfig, fused_qkv: bool = False):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        downs, cur = [], chans[0]
        for i, ch in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(_resnet(cur, ch))
                cur = ch
            samp = [Downsample(ch, asymmetric_pad=True)] if i < len(chans) - 1 else []
            downs.append(Level(res, (), samp, "downsamplers"))
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = Level([_resnet(cur, cur), _resnet(cur, cur)],
                               [AttnBlock2D(cur, fused_qkv=fused_qkv)])
        self.conv_norm_out = GroupNorm(cur, eps=EPS, silu=True)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, x.to(self.conv_in.weight.dtype))
        for level in self.down_blocks:
            for res in level.resnets:
                h = res(h)
            for samp in getattr(level, "downsamplers", ()):
                h = samp(h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return conv_nhwc(self.conv_out, self.conv_norm_out(h)).float()


class AutoencoderKL(nn.Module):
    """decode(z) -> image in [-1, 1]; encode(x) -> (mean, logvar).

    A state dict without the encoder's keys (a decoder-only checkpoint)
    loads for decoding and leaves ``has_encoder`` False, and then
    :meth:`encode` raises.  ``fused_qkv``: the mid attentions' fused
    ``to_qkv``, as the JAX package's VAE under ``SDBL_FUSED_QKV=1``."""

    def __init__(self, config: VAEConfig, fused_qkv: bool = False):
        super().__init__()
        self.config = config
        self.fused_qkv = bool(fused_qkv)
        self.decoder = Decoder(config, self.fused_qkv)
        self.encoder = Encoder(config, self.fused_qkv)
        self.post_quant_conv = (nn.Conv2d(config.latent_channels, config.latent_channels, 1)
                                if config.use_quant_conv else None)
        self.quant_conv = (nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
                           if config.use_quant_conv else None)
        self.has_encoder = True

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``; a state dict with no encoder key
        keeps the encoder's current weights and marks it not loaded."""
        has_encoder = any(k.startswith(ENCODER_KEYS) for k in state_dict)
        if not has_encoder:
            own = {k: v for k, v in self.state_dict().items() if k.startswith(ENCODER_KEYS)}
            state_dict = {**own, **state_dict}
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.has_encoder = has_encoder
        return out

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image [B, H, W, 3] in [-1, 1] -> (mean, logvar) [B, h, w, C] fp32,
        logvar clipped to [-30, 20]."""
        if not self.has_encoder:
            raise RuntimeError("this VAE was loaded without its encoder's weights (a decoder-only "
                               "checkpoint): img2img and inpainting need the encoder")
        h = self.encoder(x).to(self.encoder.conv_in.weight.dtype)
        if self.quant_conv is not None:
            h = conv_nhwc(self.quant_conv, h)
        mean, logvar = h.float().chunk(2, dim=-1)
        return mean, logvar.clamp(LOGVAR_MIN, LOGVAR_MAX)

    def encode_sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Scaled latents ``(mean + exp(logvar / 2) * noise - shift) * scale``
        of an image in [-1, 1].  ``noise`` [B, h, w, C] (the latents' shape)
        is the posterior sample's standard normal draw; without it the draw
        comes from the CPU ``generator`` (torch's default one if None)."""
        mean, logvar = self.encode(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(mean.device)
        if noise.shape != mean.shape:
            raise ValueError(f"encode noise {tuple(noise.shape)} != latents {tuple(mean.shape)}")
        z = mean + torch.exp(0.5 * logvar) * noise
        return (z - self.config.shift_factor) * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, C] -> image [B, 8h, 8w, 3] in [-1, 1] (fp32):
        divide by the scaling factor, then post_quant_conv, then the decoder."""
        z = z / self.config.scaling_factor + self.config.shift_factor
        z = z.to(self.decoder.conv_in.weight.dtype)
        if self.post_quant_conv is not None:
            z = conv_nhwc(self.post_quant_conv, z)
        return self.decoder(z)

    forward = decode
