"""Plain PyTorch networks of Stable Diffusion: the UNet (SD-1.5 and SDXL
geometries), the VAE decoder and the CLIP text towers.

Written from diffusers' ``UNet2DConditionModel`` and ``AutoencoderKL`` and
transformers' ``CLIPTextModel(WithProjection)``, built from the published
``config.json`` fields that ``portbench/configs/<name>.json`` holds, with
their parameter names.  Maps are NCHW, tokens [B, N, C]; every operation
is a stock torch op (``F.conv2d``, ``F.linear``, ``F.group_norm``, matmul
and softmax), so the networks run on any device and on the meta device,
where ``census.py`` counts their work.  Nothing here imports the port.

Two conventions are the benchmark's own, stated in the configs' files:
GroupNorm takes gcd(channels, groups) groups where the channels do not
divide (only the CPU tests' tiny configs reach that), and the VAE's mid
attention keeps diffusers' q/k/v biases, which the benchmark's weights
set to zero (``weights.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.Module):
    """GroupNorm over NCHW maps or [B, N, C] tokens, then SiLU where
    ``silu``; ``groups`` becomes gcd(channels, groups)."""

    def __init__(self, channels: int, groups: int, eps: float, silu: bool):
        super().__init__()
        self.groups, self.eps, self.silu = math.gcd(channels, groups), eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


class Attention(nn.Module):
    """Multi-head attention, softmax(q k^T / sqrt(d)) v, with an optional
    cross context and an optional causal mask."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False, names=("to_q", "to_k", "to_v", "to_out")):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.names = names
        q, k, v, o = names
        setattr(self, q, nn.Linear(dim, dim, bias=qkv_bias))
        setattr(self, k, nn.Linear(context_dim or dim, dim, bias=qkv_bias))
        setattr(self, v, nn.Linear(context_dim or dim, dim, bias=qkv_bias))
        if o == "to_out":
            self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        else:
            setattr(self, o, nn.Linear(dim, dim))

    def out_proj_layer(self) -> nn.Linear:
        o = self.names[3]
        return self.to_out[0] if o == "to_out" else getattr(self, o)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        qn, kn, vn, _ = self.names
        ctx = x if context is None else context
        B, N, _ = x.shape
        M = ctx.shape[1]
        q = getattr(self, qn)(x).view(B, N, self.heads, self.head_dim).transpose(1, 2)
        k = getattr(self, kn)(ctx).view(B, M, self.heads, self.head_dim).transpose(1, 2)
        v = getattr(self, vn)(ctx).view(B, M, self.heads, self.head_dim).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        if causal:
            keep = torch.ones(N, M, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, float("-inf"))
        o = torch.matmul(logits.softmax(dim=-1), v)
        return self.out_proj_layer()(o.transpose(1, 2).reshape(B, N, -1))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' ``get_timestep_embedding`` with flip_sin_to_cos True and
    freq_shift 0: [cos, sin] of t * 10000^(-i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps, silu=True)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = GroupNorm(cout, groups, eps, silu=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        h = self.norm3(x)
        for layer in self.ff.net:
            h = layer(h)
        return x + h


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in (1x1 conv, or linear with
    ``linear``) -> blocks -> proj_out, plus the residual."""

    def __init__(self, ch: int, heads: int, context_dim: int, depth: int, linear: bool,
                 groups: int):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(ch, groups, 1e-6, silu=False)
        make = (lambda: nn.Linear(ch, ch)) if linear else (lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in = make()
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim) for _ in range(depth)])
        self.proj_out = make()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        if not self.linear:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        if self.linear:
            h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.linear:
            h = self.proj_out(h)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        if not self.linear:
            h = self.proj_out(h)
        return h + x


class Sampler(nn.Module):
    """A down- or upsampler: a 3x3 conv (stride 2 for down; after a nearest
    2x resize for up)."""

    def __init__(self, ch: int, up: bool):
        super().__init__()
        self.up = up
        self.conv = nn.Conv2d(ch, ch, 3, stride=1 if up else 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


def _per_level(value, n: int) -> List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class UNet(nn.Module):
    """diffusers' ``UNet2DConditionModel`` for the fields of an SD-1.5 or
    SDXL ``unet/config.json``.  As in diffusers, ``attention_head_dim``
    gives the number of heads where ``num_attention_heads`` is absent."""

    def __init__(self, cfg: Dict):
        super().__init__()
        chans = list(cfg["block_out_channels"])
        n = len(chans)
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        heads = _per_level(cfg.get("num_attention_heads") or cfg["attention_head_dim"], n)
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
        ctx_dim = cfg["cross_attention_dim"]
        linear = bool(cfg.get("use_linear_projection", False))
        self.cross = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        self.layers_per_block = cfg["layers_per_block"]
        temb = chans[0] * 4
        self.base = chans[0]
        self.conv_in = nn.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        self.add_time_dim = cfg.get("addition_time_embed_dim")
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"],
                                                   temb)
        skips, cur = [chans[0]], chans[0]
        self.down_blocks = nn.ModuleList()
        for lvl, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if self.cross[lvl]:
                blk.attentions = nn.ModuleList()
            for _ in range(self.layers_per_block):
                blk.resnets.append(ResnetBlock(cur, ch, temb, groups, eps))
                cur = ch
                if self.cross[lvl]:
                    blk.attentions.append(Transformer2D(ch, heads[lvl], ctx_dim, depth[lvl],
                                                        linear, groups))
                skips.append(ch)
            if lvl < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(ch, up=False)])
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock(cur, cur, temb, groups, eps),
                                                ResnetBlock(cur, cur, temb, groups, eps)])
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2D(cur, heads[-1], ctx_dim, depth[-1], linear, groups)])
        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(n)):
            ch = chans[lvl]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if self.cross[lvl]:
                blk.attentions = nn.ModuleList()
            for _ in range(self.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(cur + skips.pop(), ch, temb, groups, eps))
                cur = ch
                if self.cross[lvl]:
                    blk.attentions.append(Transformer2D(ch, heads[lvl], ctx_dim, depth[lvl],
                                                        linear, groups))
            if lvl > 0:
                blk.upsamplers = nn.ModuleList([Sampler(ch, up=True)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(chans[0], groups, eps, silu=True)
        self.conv_out = nn.Conv2d(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                pooled: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, h, w], t [B], context [B, T, D]; SDXL adds pooled [B, P]
        and time_ids [B, 6].  Returns the model output [B, C, h, w]."""
        temb = self.time_embedding(timestep_embedding(t, self.base))
        if hasattr(self, "add_embedding"):
            B = x.shape[0]
            ids = timestep_embedding(time_ids.reshape(-1), self.add_time_dim).reshape(B, -1)
            temb = temb + self.add_embedding(torch.cat([pooled, ids], dim=-1))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class VAEAttention(Attention):
    """The VAE mid block's single-head attention: GroupNorm (eps 1e-6),
    q/k/v with biases, out projection, residual."""

    def __init__(self, ch: int, groups: int):
        super().__init__(ch, 1, qkv_bias=True)
        self.group_norm = GroupNorm(ch, groups, 1e-6, silu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        return x + super().forward(h).reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    """``AutoencoderKL``'s ``post_quant_conv`` and ``decoder`` (diffusers
    names): scaled latents [B, C, h, w] -> image [B, 3, 8h, 8w] in [-1, 1]
    (not clamped)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        chans = list(cfg["block_out_channels"])
        groups, lat = cfg["norm_num_groups"], cfg["latent_channels"]
        self.scaling_factor = float(cfg["scaling_factor"])
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        dec = self.decoder = nn.Module()
        top = chans[-1]
        dec.conv_in = nn.Conv2d(lat, top, 3, padding=1)
        dec.mid_block = nn.Module()
        dec.mid_block.resnets = nn.ModuleList([ResnetBlock(top, top, None, groups, 1e-6),
                                               ResnetBlock(top, top, None, groups, 1e-6)])
        dec.mid_block.attentions = nn.ModuleList([VAEAttention(top, groups)])
        dec.up_blocks = nn.ModuleList()
        cur = top
        rev = list(reversed(chans))
        for i, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg["layers_per_block"] + 1):
                blk.resnets.append(ResnetBlock(cur, ch, None, groups, 1e-6))
                cur = ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(ch, up=True)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = GroupNorm(cur, groups, 1e-6, silu=True)
        dec.conv_out = nn.Conv2d(cur, cfg["out_channels"], 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z / self.scaling_factor))
        h = dec.mid_block.resnets[0](h)
        h = dec.mid_block.attentions[0](h)
        h = dec.mid_block.resnets[1](h)
        for blk in dec.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return dec.conv_out(dec.conv_norm_out(h))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, heads: int, inner: int, act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim)
        self.self_attn = Attention(dim, heads, qkv_bias=True,
                                   names=("q_proj", "k_proj", "v_proj", "out_proj"))
        self.layer_norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, inner)
        self.mlp.fc2 = nn.Linear(inner, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal=True)
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class CLIPText(nn.Module):
    """transformers' ``CLIPTextModel`` (``text_model.*``), with
    ``text_projection`` for ``CLIPTextModelWithProjection``.  ``forward``
    gives the last hidden state (after the final LayerNorm), the
    penultimate one (the last layer's input) and the pooled output (the
    last hidden state at the first highest id: the end-of-text token)."""

    def __init__(self, cfg: Dict, projection: bool = False):
        super().__init__()
        dim = cfg["hidden_size"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], dim)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], dim)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(dim, cfg["num_attention_heads"], cfg["intermediate_size"],
                       cfg["hidden_act"]) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(dim)
        if projection:
            self.text_projection = nn.Linear(dim, cfg["projection_dim"], bias=False)

    def forward(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        tm = self.text_model
        T = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:T]
        *head, last = tm.encoder.layers
        for layer in head:
            x = layer(x)
        penultimate = x
        x = tm.final_layer_norm(last(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
        return {"last": x, "penultimate": penultimate, "pooled": pooled}
