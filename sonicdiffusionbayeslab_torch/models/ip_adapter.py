"""IP-Adapter (Ye et al. 2023): image-prompt conditioning.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/ip_adapter.py``.  A
projection (:class:`ImageProjection`) maps a CLIP image embedding to
``num_tokens`` context tokens, and every cross-attention of the UNet gains
decoupled ``to_k_ip``/``to_v_ip`` projections whose attention over those
tokens, scaled, is added to the text attention before ``to_out``
(``layers.Attention``).  The base UNet's weights are untouched.

Checkpoint layout (the published ``ip-adapter_sd15.bin``)::

    {"image_proj": {"proj.weight", "proj.bias", "norm.weight", "norm.bias"},
     "ip_adapter": {"<idx>.to_k_ip.weight", "<idx>.to_v_ip.weight", ...}}

``<idx>`` is the attention processor's index in diffusers'
``unet.attn_processors`` order (each transformer block's attn1 and attn2,
down blocks, mid block, up blocks), so the cross-attentions sit at the odd
indices.  Here the state dicts carry the port's names: the UNet's
``...attn2.to_k_ip.weight`` and the projection's ``proj.*``/``norm.*``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.unet import UNetConfig

IP_NAMES = ("to_k_ip", "to_v_ip")


class ImageProjection(nn.Module):
    """CLIP image embedding [B, E] -> ``num_tokens`` context tokens
    [B, P, cross_attention_dim] (diffusers ``ImageProjection``)."""

    def __init__(self, embed_dim: int, cross_attention_dim: int, num_tokens: int = 4):
        super().__init__()
        self.num_tokens, self.cross_attention_dim = num_tokens, cross_attention_dim
        self.proj = nn.Linear(embed_dim, num_tokens * cross_attention_dim)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    @property
    def embed_dim(self) -> int:
        return self.proj.weight.shape[1]

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim))


def ip_attn_paths(cfg: UNetConfig) -> List[str]:
    """The UNet's module name of every cross-attention, in diffusers'
    ``attn_processors`` order (the attn2 of each transformer block: down
    blocks, mid block, up blocks)."""
    paths: List[str] = []
    n = len(cfg.block_out_channels)
    for lvl in range(n):
        if cfg.cross_attention[lvl]:
            paths += [f"down_blocks.{lvl}.attentions.{j}.transformer_blocks.{d}.attn2"
                      for j in range(cfg.layers_per_block) for d in range(cfg.depth_at(lvl))]
    paths += [f"mid_block.attentions.0.transformer_blocks.{d}.attn2"
              for d in range(cfg.depth_at(n - 1))]
    for lvl in reversed(range(n)):  # diffusers' up_blocks[0] is the deepest level
        if cfg.cross_attention[lvl]:
            paths += [f"up_blocks.{n - 1 - lvl}.attentions.{j}.transformer_blocks.{d}.attn2"
                      for j in range(cfg.layers_per_block + 1) for d in range(cfg.depth_at(lvl))]
    return paths


def ip_processor_indices(cfg: UNetConfig) -> List[int]:
    """The ``<idx>`` each cross-attention carries in a checkpoint: every
    attention (attn1 and attn2) counts, so cross-attentions are odd."""
    return [2 * i + 1 for i in range(len(ip_attn_paths(cfg)))]


def load_ip_adapter(path: str | Path, cfg: UNetConfig) -> Dict:
    """An IP-Adapter ``.bin`` (``torch.load(weights_only=True)``) -> {"unet_ip":
    the UNet's ``to_k_ip``/``to_v_ip`` entries, "image_proj": the
    projection's state dict, "num_tokens", "embed_dim"}; merge with
    :func:`merge_ip_params`.  Missing or unmapped tensors raise."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    proj = {k: v.float() for k, v in sd["image_proj"].items()}
    ip_sd = {k: v.float() for k, v in sd["ip_adapter"].items()}
    w = proj["proj.weight"]  # [P * C, E]
    unet_ip = {}
    for name, idx in zip(ip_attn_paths(cfg), ip_processor_indices(cfg)):
        for p in IP_NAMES:
            src = f"{idx}.{p}.weight"
            if src not in ip_sd:
                raise KeyError(f"ip_adapter checkpoint missing {src} for {name}")
            unet_ip[f"{name}.{p}.weight"] = ip_sd[src]
    extra = set(ip_sd) - {f"{i}.{p}.weight" for i in ip_processor_indices(cfg) for p in IP_NAMES}
    if extra:
        raise KeyError(f"ip_adapter checkpoint has unmapped tensors, e.g. {sorted(extra)[:3]}")
    return {"unet_ip": unet_ip, "image_proj": proj,
            "num_tokens": int(w.shape[0]) // cfg.cross_attention_dim, "embed_dim": int(w.shape[1])}


def export_ip_adapter(unet_sd: Dict[str, torch.Tensor], image_proj_sd: Dict[str, torch.Tensor],
                      cfg: UNetConfig) -> Dict:
    """Inverse of :func:`load_ip_adapter`: a UNet state dict holding the IP
    projections and the projection's state dict -> the checkpoint layout."""
    ip_sd = {f"{idx}.{p}.weight": unet_sd[f"{name}.{p}.weight"].detach().cpu()
             for name, idx in zip(ip_attn_paths(cfg), ip_processor_indices(cfg)) for p in IP_NAMES}
    return {"image_proj": {k: v.detach().cpu() for k, v in image_proj_sd.items()},
            "ip_adapter": ip_sd}


def extract_ip_params(unet_sd: Dict[str, torch.Tensor], cfg: UNetConfig) -> Dict:
    """The ``to_k_ip``/``to_v_ip`` entries of a UNet state dict."""
    return {f"{name}.{p}.weight": unet_sd[f"{name}.{p}.weight"]
            for name in ip_attn_paths(cfg) for p in IP_NAMES}


def merge_ip_params(unet: nn.Module, unet_ip: Dict[str, torch.Tensor]) -> nn.Module:
    """Add the IP projections to ``unet`` (``add_ip_adapter``) and load
    ``unet_ip`` into them, every one of them, in place."""
    unet.add_ip_adapter()
    want = set(extract_ip_params(unet.state_dict(), unet.config))
    if set(unet_ip) != want:
        missing, extra = sorted(want - set(unet_ip)), sorted(set(unet_ip) - want)
        raise KeyError(f"IP-Adapter entries: missing {missing[:3]}, unexpected {extra[:3]}")
    with torch.no_grad():
        params = dict(unet.named_parameters())
        for k, v in unet_ip.items():
            params[k].copy_(v)
    return unet
