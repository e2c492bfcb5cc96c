"""UNet2DCondition (SD-1.5, SD-2.x and SDXL geometries) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/unet.py`` on the
text-to-image path with its DeepCache split, Token Merging, SDXL's
text_time added conditioning, a full LCM model's guidance embedding
(``time_cond_proj_dim``, ``timestep_cond``), the int8 W8A8 modes,
ControlNet's residuals, IP-Adapter's decoupled cross-attentions, the CFG
shared prefix (``cfg_shared_prefix``) and fused q/k/v projections
(``fused_qkv``, the JAX package's ``SDBL_FUSED_QKV=1`` tree).
Parameter names follow diffusers' ``UNet2DConditionModel``; activations
are [B, H, W, C] at the module's boundary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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
    seq_conv,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 defaults (runwayml/stable-diffusion-v1-5 unet/config.json).

    ``transformer_depth`` and ``num_attention_heads`` are a scalar (the same
    at every level, SD-1.5) or one value a level (SD-2.x heads, SDXL); the
    mid block takes the last level's.  ``addition_time_embed_dim`` set means
    SDXL's text_time conditioning: each of the 6 ``time_ids`` embedded
    sinusoidally at that width, concatenated after the pooled text
    embedding into ``projection_class_embeddings_input_dim`` features, goes
    through ``add_embedding`` and is added to the time embedding.
    ``use_linear_projection`` (diffusers' flag): the transformers'
    ``proj_in``/``proj_out`` are ``nn.Linear`` (SD-2.x, SDXL) rather than
    1x1 convs (SD-1.5); None follows ``addition_time_embed_dim``.
    ``time_cond_proj_dim`` (diffusers' name) set means a w-conditioned,
    full LCM UNet: the time embedding's ``cond_proj`` takes a guidance
    embedding of that width (``sampler.guidance_scale_embedding``), e.g. 256
    for LCM_Dreamshaper_v7."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    cross_attention_dim: int = 768
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None
    use_linear_projection: Optional[bool] = None
    time_cond_proj_dim: Optional[int] = None

    @property
    def linear_projection(self) -> bool:
        if self.use_linear_projection is not None:
            return bool(self.use_linear_projection)
        return self.addition_time_embed_dim is not None

    def depth_at(self, lvl: int) -> int:
        d = self.transformer_depth
        return int(d[lvl]) if isinstance(d, (tuple, list)) else int(d)

    def heads_at(self, lvl: int) -> int:
        h = self.num_attention_heads
        return int(h[lvl]) if isinstance(h, (tuple, list)) else int(h)

    @property
    def pooled_dim(self) -> Optional[int]:
        """Width of the pooled text embedding the text_time conditioning takes."""
        if self.addition_time_embed_dim is None:
            return None
        return self.projection_class_embeddings_input_dim - 6 * self.addition_time_embed_dim

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """2-level random-weight UNet for CPU tests."""
        return cls(block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention=(True, False), num_attention_heads=2,
                   cross_attention_dim=32)

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def sd21(cls) -> "UNetConfig":
        """stabilityai/stable-diffusion-2-1 unet/config.json: SD-1.5's
        topology with 64-wide heads (attention_head_dim [5, 10, 20, 20]),
        OpenCLIP ViT-H context (1024) and linear projections."""
        return cls(num_attention_heads=(5, 10, 20, 20), cross_attention_dim=1024,
                   use_linear_projection=True)

    @classmethod
    def tiny21(cls) -> "UNetConfig":
        """2-level SD-2.x-shaped UNet (linear projections, heads a level)."""
        return cls(block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention=(True, False), num_attention_heads=(2, 4),
                   cross_attention_dim=32, use_linear_projection=True)

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        """stabilityai/stable-diffusion-xl-base-1.0 unet/config.json."""
        return cls(block_out_channels=(320, 640, 1280), layers_per_block=2,
                   cross_attention=(False, True, True), transformer_depth=(1, 2, 10),
                   num_attention_heads=(5, 10, 20), cross_attention_dim=2048,
                   addition_time_embed_dim=256,
                   projection_class_embeddings_input_dim=2816)  # pooled 1280 + 6 * 256

    @classmethod
    def tiny_xl(cls) -> "UNetConfig":
        """2-level SDXL-shaped UNet (depth and heads a level, text_time)."""
        return cls(block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention=(False, True), transformer_depth=(1, 2),
                   num_attention_heads=(2, 4), cross_attention_dim=32,
                   addition_time_embed_dim=8,
                   projection_class_embeddings_input_dim=16 + 6 * 8)  # pooled 16 + ids


def _transformer(cfg: UNetConfig, lvl: int, fused_qkv: bool = False) -> SpatialTransformer:
    ch, heads = cfg.block_out_channels[lvl], cfg.heads_at(lvl)
    return SpatialTransformer(ch, heads, ch // heads, cfg.cross_attention_dim,
                              depth=cfg.depth_at(lvl), linear=cfg.linear_projection,
                              fused_qkv=fused_qkv)


def tiled(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` repeated to ``like``'s batch where that is twice x's, else x:
    the CFG shared prefix's B-row time embedding and skip states where a
    2B activation meets them (the JAX UNet's ``temb_for``/``skip_for``)."""
    return torch.cat([x, x]) if like.shape[0] == 2 * x.shape[0] else x


def build_encoder(module: nn.Module, cfg: UNetConfig, fused_qkv: bool = False):
    """The encoder half of the UNet on ``module``, under diffusers' names:
    ``conv_in``, ``time_embedding`` (and SDXL's ``add_embedding``),
    ``down_blocks`` and ``mid_block``; the UNet and the ControlNet's copy
    share it.  ``fused_qkv``: the transformers' fused projections.
    Returns the channels of each skip state, in order."""
    chans = cfg.block_out_channels
    n, temb = len(chans), chans[0] * 4
    module.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
    module.time_embedding = TimestepEmbedMLP(chans[0], temb, cfg.time_cond_proj_dim)
    if cfg.addition_time_embed_dim is not None:
        module.add_embedding = TimestepEmbedMLP(cfg.projection_class_embeddings_input_dim, temb)
    skip_ch, cur = [chans[0]], chans[0]
    down = []
    for lvl, ch in enumerate(chans):
        res, att = [], []
        for _ in range(cfg.layers_per_block):
            res.append(ResnetBlock(cur, ch, temb))
            cur = ch
            if cfg.cross_attention[lvl]:
                att.append(_transformer(cfg, lvl, fused_qkv))
            skip_ch.append(ch)
        samp = [Downsample(ch, allow_quant=True)] if lvl < n - 1 else []
        if samp:
            skip_ch.append(ch)
        down.append(Level(res, att, samp, "downsamplers"))
    module.down_blocks = nn.ModuleList(down)
    mid = chans[-1]
    module.mid_block = Level([ResnetBlock(cur, mid, temb), ResnetBlock(mid, mid, temb)],
                             [_transformer(cfg, n - 1, fused_qkv)])
    return skip_ch


def time_embedding(module: nn.Module, cfg: UNetConfig, timesteps: torch.Tensor,
                   text_embeds: Optional[torch.Tensor], time_ids: Optional[torch.Tensor],
                   batch: int, timestep_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``module``'s time embedding of ``timesteps`` (a scalar broadcasts to
    ``batch``), with ``timestep_cond`` through ``cond_proj`` where the config
    has ``time_cond_proj_dim`` (required there, ignored elsewhere), plus
    SDXL's text_time conditioning where the config has it: add_embedding
    of [pooled text embedding, sinusoids of the 6 time_ids] (diffusers'
    addition_embed_type "text_time")."""
    dt = module.conv_in.weight.dtype
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(batch)
    if cfg.time_cond_proj_dim is None:
        timestep_cond = None
    elif timestep_cond is None:
        raise ValueError("this UNet config requires timestep_cond (guidance embedding, "
                         f"dim {cfg.time_cond_proj_dim})")
    t_emb = module.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt),
                                  timestep_cond)
    if cfg.addition_time_embed_dim is None:
        return t_emb
    if text_embeds is None or time_ids is None:
        raise ValueError("this UNet config requires added conditioning: text_embeds "
                         "(pooled) and time_ids")
    B, K = time_ids.shape
    ids = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
    add_in = torch.cat([text_embeds.float(), ids.reshape(B, K * cfg.addition_time_embed_dim)],
                       dim=-1)
    want = cfg.projection_class_embeddings_input_dim
    if add_in.shape[-1] != want:
        raise ValueError(f"added conditioning width {add_in.shape[-1]} != "
                         f"projection_class_embeddings_input_dim {want}")
    return t_emb + module.add_embedding(add_in.to(dt))


def encoder_levels(module: nn.Module, h: torch.Tensor, t_emb: torch.Tensor, xfmr,
                   last: int, downsample_last: bool):
    """Down levels ``0..last`` of ``module``'s encoder from ``conv_in``'s
    output ``h``: (h, the skip states, ``h`` first), each level's
    downsample included except the last's unless ``downsample_last``;
    ``xfmr(attn, lvl, h)`` runs a transformer."""
    skips = [h]
    for lvl, level in enumerate(module.down_blocks[:last + 1]):
        attns = getattr(level, "attentions", None)
        for j, res in enumerate(level.resnets):
            h = res(h, tiled(t_emb, h))
            if attns is not None:
                h = xfmr(attns[j], lvl, h)
            skips.append(h)
        if downsample_last or lvl < last:
            for samp in getattr(level, "downsamplers", ()):
                h = samp(h)
                skips.append(h)
    return h, skips


def mid_level(module: nn.Module, h: torch.Tensor, t_emb: torch.Tensor, xfmr) -> torch.Tensor:
    n = len(module.down_blocks)
    h = module.mid_block.resnets[0](h, tiled(t_emb, h))
    h = xfmr(module.mid_block.attentions[0], n - 1, h)
    return module.mid_block.resnets[1](h, tiled(t_emb, h))


class UNet2DCondition(nn.Module):
    """``quant_mode``: the int8 mode of the whole UNet (``ops.quant``), set
    with ``ops.quant.set_quant_mode``; None is exact.  The ResnetBlocks'
    and the Downsample/Upsample 3x3 convs quantize under the conv modes
    (50 convs a SD-1.5 forward), the transformers' projections under
    ``int8`` and ``int8_conv``.

    Placed on a mesh (``parallel.mesh.place_module``) it runs split: under
    ``model`` each layer keeps its share of heads, hidden units and
    channels (``models/layers.py``), under ``seq`` ``sample`` and the
    outputs hold the rank's rows of the latent height, which must divide
    by ``seq_multiple`` on every rank (every level splits alike).

    ``fused_qkv``: every attention's q/k/v projections fused (``to_qkv`` in
    the self-attentions, ``to_q`` and ``to_kv`` in the crosses)."""

    quant_mode = None
    par = None

    def __init__(self, config: UNetConfig, fused_qkv: bool = False):
        super().__init__()
        cfg = self.config = config
        self.fused_qkv = bool(fused_qkv)
        chans = cfg.block_out_channels
        n = len(chans)
        temb = chans[0] * 4

        skip_ch = build_encoder(self, cfg, self.fused_qkv)
        cur = chans[-1]

        up = []  # diffusers up_blocks[k] is level n - 1 - k
        for lvl in reversed(range(n)):
            ch = chans[lvl]
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(cur + skip_ch.pop(), ch, temb))
                cur = ch
                if cfg.cross_attention[lvl]:
                    att.append(_transformer(cfg, lvl, self.fused_qkv))
            samp = [Upsample(ch, allow_quant=True)] if lvl > 0 else []
            up.append(Level(res, att, samp, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(chans[0], silu=True)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    @property
    def seq_multiple(self) -> int:
        """What a rank's share of the latent height must divide by: one row
        at the deepest level."""
        return 2 ** (len(self.config.block_out_channels) - 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, cache: Optional[torch.Tensor] = None,
                tome_dst: Optional[torch.Tensor] = None,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None,
                ip_context: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None, return_cache: bool = False,
                cache_branch_id: int = 0, tome=None, control_residuals=None,
                timestep_cond: Optional[torch.Tensor] = None, cfg_shared_prefix: bool = False):
        """sample [B, h, w, C_in], timesteps [B] or scalar, context [B, T, D]
        -> [B, h, w, C_out] fp32.

        SDXL's text_time conditioning (the JAX package's ``added_cond``):
        ``text_embeds`` [B, P] pooled text embeddings and ``time_ids`` [B, 6],
        required where the config has ``addition_time_embed_dim``.
        ``timestep_cond`` [B, time_cond_proj_dim], the guidance embedding of
        a w-conditioned (full LCM) UNet, required where the config has
        ``time_cond_proj_dim`` and ignored elsewhere.  They are tensor
        arguments, so a CUDA graph of the call copies them in at every
        replay (``engine.denoise`` takes ``timestep_cond`` positionally,
        after the control image's scale).

        IP-Adapter: ``ip_context`` [B, P, D] image-prompt tokens and
        ``ip_scale`` (a 0-dim tensor) go to every cross-attention's
        decoupled projections (``add_ip_adapter`` adds them).

        ControlNet: ``control_residuals`` (down residuals, one a skip state;
        the mid residual) from ``ControlNet`` are added to the skip states
        and to the mid block's output; a DeepCache step refuses them.

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
        is its destination.

        CFG shared prefix (``cfg_shared_prefix``): ``sample`` and
        ``timesteps`` are the single latent copy [B] and the context the
        CFG-doubled [negative | positive] [2B].  The two halves agree until
        the first cross-attention (the same latents and timestep), so
        ``conv_in``, the leading resnets and the first transformer's
        self-attention run once at B and the activations tile to 2B there;
        the output is [2B, ...].  The same math as the plain call.  It
        composes with Token Merging and the split layers only (no SDXL
        conditioning, IP-Adapter, DeepCache, ControlNet or
        ``timestep_cond``), as in the JAX package."""
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
        if control_residuals is not None and not deep:
            raise ValueError("control_residuals cannot be combined with a DeepCache step")
        t_emb = time_embedding(self, cfg, timesteps, text_embeds, time_ids, sample.shape[0],
                               timestep_cond)
        ctx = encoder_hidden_states.to(dt)
        if cfg_shared_prefix:
            if (text_embeds is not None or time_ids is not None or ip_context is not None
                    or cache is not None or return_cache or control_residuals is not None
                    or timestep_cond is not None):
                raise ValueError("cfg_shared_prefix composes with the plain UNet path only (no "
                                 "SDXL added_cond / IP-Adapter / DeepCache / ControlNet / "
                                 "timestep_cond)")
            if ctx.shape[0] != 2 * sample.shape[0]:
                raise ValueError(f"cfg_shared_prefix expects context batch {ctx.shape[0]} == 2 x "
                                 f"sample batch {sample.shape[0]}")
        ip = {} if ip_context is None else dict(ip_context=ip_context.to(dt), ip_scale=ip_scale)
        slot, tome_cache, pending = 0, {}, bool(cfg_shared_prefix)

        def xfmr(attn, lvl, h):
            nonlocal slot, pending
            tile, pending = pending, False  # only the first transformer tiles
            if tome is None or (1 << lvl) > tome.max_downsample:
                return attn(h, ctx, **ip, cfg_tile=tile)
            depth = len(attn.transformer_blocks)
            dst = None if tome_dst is None else tome_dst[slot:slot + depth]
            slot += depth
            return attn(h, ctx, tome, dst, tome_cache, **ip, cfg_tile=tile)

        h = seq_conv(self.conv_in, sample.to(dt), self.par)
        # Level b's downsample feeds only the trunk.
        h, skips = encoder_levels(self, h, t_emb, xfmr, n - 1 if deep else branch, deep)
        if control_residuals is not None:
            down_r, mid_r = control_residuals
            if len(down_r) != len(skips):
                raise ValueError(f"{len(down_r)} control residuals != {len(skips)} skip states")
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_r)]

        # up_blocks[k] is level n - 1 - k.
        up = [(n - 1 - k, level) for k, level in enumerate(self.up_blocks)]
        if deep:
            h = mid_level(self, h, t_emb, xfmr)
            if control_residuals is not None:
                h = h + mid_r.to(h.dtype)
            h = self._up(up[:n - 1 - branch], h, skips, t_emb, xfmr)
            deep_features = h
        else:
            deep_features = h = cache.to(dt)
        h = self._up(up[n - 1 - branch:], h, skips, t_emb, xfmr)

        h = self.conv_norm_out(h)
        out = seq_conv(self.conv_out, h, self.par).float()
        return (out, deep_features) if return_cache else out

    def cross_attentions(self):
        """(name, module) of every cross-attention (each transformer block's
        ``attn2``) in diffusers' ``attn_processors`` order: down blocks,
        mid block, up blocks."""
        return [(name, m) for name, m in self.named_modules() if name.endswith(".attn2")]

    def add_ip_adapter(self) -> "UNet2DCondition":
        """Add IP-Adapter's ``to_k_ip``/``to_v_ip`` to every cross-attention
        (no-op where present); their weights are then loaded."""
        for _, attn in self.cross_attentions():
            attn.add_ip()
        return self

    @staticmethod
    def _up(levels, h, skips, t_emb, xfmr):
        for lvl, level in levels:
            attns = getattr(level, "attentions", None)
            for j, res in enumerate(level.resnets):
                h = torch.cat([h, tiled(skips.pop(), h)], dim=-1)
                h = res(h, tiled(t_emb, h))
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
                slots += [(site, i) + shapes[lvl] for i in range(cfg.depth_at(lvl))]
                site += 1
        return slots

    def cache_shape(self, height: int, width: int, cache_branch_id: int = 0):
        """Shape (without the batch) of the trunk output a ``[*, height,
        width, *]`` sample gives: up level b's input, at height / 2^b with
        up level b + 1's width (the mid block's when b is the deepest)."""
        b = int(cache_branch_id)
        chans = self.config.block_out_channels
        return (height >> b, width >> b, chans[min(b + 1, len(chans) - 1)])
