"""JAX parameter trees and local checkpoints -> the port's modules.

The port's own copies of the name maps in
``sonicdiffusionbayeslab_tpu/models/weights.py`` (``unet_name_map``,
``vae_name_map``, ``clip_text_name_map``, ``clip_dual_name_map``,
``mmdit_name_map``, ``t5_name_map``, ``controlnet_name_map``) and of
``invert``: for every JAX parameter path, the diffusers / transformers
tensor name and the layout change (HWIO conv -> OIHW, [in, out] dense ->
[out, in], dense -> [out, in, 1, 1] for SD-1.5's 1x1-conv transformer
projections; SD-2.x's and SDXL's are linears).  The metric towers' maps follow the JAX package's loaders
of the published files (``image_reward_name_map``: ImageReward-v1.0's
names; ``inception_name_map``: pytorch-fid's; ``aesthetic_name_map``:
the LAION head's), and ``*_from_jax`` turn those JAX trees into the
port's state dicts.  The port's modules carry exactly those names, so a local
diffusers snapshot or transformers CLIP checkpoint loads by name
(``load_sd_checkpoint``, ``load_sdxl_checkpoint``, ``load_sd3_checkpoint``,
``load_clip_checkpoint``, ``load_controlnet_checkpoint``; ``write_snapshot``
writes one), strictly, after dropping by name the few keys
the port's modules do not have.  Fused q/k/v projections (``to_qkv``,
``to_kv``; the JAX package's ``SDBL_FUSED_QKV=1`` trees) have map entries
of their own, take a checkpoint's separate projections concatenated
(``fuse_projections``) and a LoRA of a separate one in their rows
(``merge_lora``).  ``lora_from_jax`` and
``mmdit_lora_from_jax`` carry a JAX LoRA adapter tree across.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.unet import UNetConfig

Transform = Callable[[np.ndarray], np.ndarray]
NameMap = Dict[str, Tuple[str, Transform]]  # jax path -> (torch name, jax -> torch)


def _conv(w):  # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):  # [in, out] -> [out, in]
    return np.transpose(w)


def _dense_to_conv1x1(w):  # [in, out] -> [out, in, 1, 1]
    return np.transpose(w)[:, :, None, None]


def _id(w):
    return np.asarray(w)


class MapEntries(dict):
    """Collects ``{jax path: (torch name, transform)}`` entries block by
    block; ``dst`` is the JAX module path, ``src`` the torch module name.
    Entries for parameters a tree lacks (``conv_shortcut`` where channels
    do not change, ``time_emb_proj`` in the VAE) are simply never read."""

    def conv(self, dst, src):
        self[f"{dst}/kernel"] = (f"{src}.weight", _conv)
        self[f"{dst}/bias"] = (f"{src}.bias", _id)

    def dense(self, dst, src, bias=True):
        self[f"{dst}/kernel"] = (f"{src}.weight", _lin)
        if bias:
            self[f"{dst}/bias"] = (f"{src}.bias", _id)

    def norm(self, dst, src):  # GroupNorm and LayerNorm: scale/bias -> weight/bias
        self[f"{dst}/scale"] = (f"{src}.weight", _id)
        self[f"{dst}/bias"] = (f"{src}.bias", _id)

    def resnet(self, dst, src):
        self.norm(f"{dst}/norm1", f"{src}.norm1")
        self.conv(f"{dst}/conv1", f"{src}.conv1")
        self.dense(f"{dst}/time_emb_proj", f"{src}.time_emb_proj")
        self.norm(f"{dst}/norm2", f"{src}.norm2")
        self.conv(f"{dst}/conv2", f"{src}.conv2")
        self.conv(f"{dst}/conv_shortcut", f"{src}.conv_shortcut")

    def attention(self, dst, src):
        # to_k_ip/to_v_ip: IP-Adapter's projections, in a tree that has them;
        # to_qkv/to_kv: the fused projections (the JAX package's
        # SDBL_FUSED_QKV=1 tree), [in, k * inner] kernels whose columns are
        # q | k | v, as rows of the port's fused weights.
        for p in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "to_qkv", "to_kv"):
            self.dense(f"{dst}/{p}", f"{src}.{p}", bias=False)
        self.dense(f"{dst}/to_out", f"{src}.to_out.0")

    def transformer_block(self, dst, src):
        self.attention(f"{dst}/attn1", f"{src}.attn1")
        self.attention(f"{dst}/attn2", f"{src}.attn2")
        self.dense(f"{dst}/ff/proj_in", f"{src}.ff.net.0.proj")
        self.dense(f"{dst}/ff/proj_out", f"{src}.ff.net.2")
        for i in (1, 2, 3):
            self.norm(f"{dst}/norm{i}", f"{src}.norm{i}")

    def spatial_transformer(self, dst, src, depth, linear=False):
        self.norm(f"{dst}/norm", f"{src}.norm")
        for p in ("proj_in", "proj_out"):  # SD-1.5: 1x1 convs; SD-2.x, SDXL: linears
            self[f"{dst}/{p}/kernel"] = (f"{src}.{p}.weight", _lin if linear else _dense_to_conv1x1)
            self[f"{dst}/{p}/bias"] = (f"{src}.{p}.bias", _id)
        for d in range(depth):
            self.transformer_block(f"{dst}/block_{d}", f"{src}.transformer_blocks.{d}")

    def attn_block2d(self, dst, src):
        self.norm(f"{dst}/norm", f"{src}.group_norm")
        self.attention(f"{dst}/attn", src)

    def clip_layer(self, dst, src):  # one transformers CLIPEncoderLayer (text and vision)
        for a in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.dense(f"{dst}/attn/{a}", f"{src}.self_attn.{a}")
        self.norm(f"{dst}/ln1", f"{src}.layer_norm1")
        self.norm(f"{dst}/ln2", f"{src}.layer_norm2")
        self.dense(f"{dst}/fc1", f"{src}.mlp.fc1")
        self.dense(f"{dst}/fc2", f"{src}.mlp.fc2")


def unet_name_map(cfg: UNetConfig) -> NameMap:
    m = MapEntries()
    lin = cfg.linear_projection
    m.conv("conv_in", "conv_in")
    m.dense("time_embedding/fc1", "time_embedding.linear_1")
    m.dense("time_embedding/fc2", "time_embedding.linear_2")
    # A full LCM UNet's guidance embedding (time_cond_proj_dim).
    m.dense("time_embedding/cond_proj", "time_embedding.cond_proj", bias=False)
    m.dense("add_embedding/fc1", "add_embedding.linear_1")  # SDXL's text_time conditioning
    m.dense("add_embedding/fc2", "add_embedding.linear_2")
    n = len(cfg.block_out_channels)
    for lvl in range(n):
        for j in range(cfg.layers_per_block):
            m.resnet(f"down_{lvl}_res_{j}", f"down_blocks.{lvl}.resnets.{j}")
            if cfg.cross_attention[lvl]:
                m.spatial_transformer(f"down_{lvl}_attn_{j}", f"down_blocks.{lvl}.attentions.{j}",
                                      cfg.depth_at(lvl), lin)
        if lvl < n - 1:
            m.conv(f"down_{lvl}_downsample/conv", f"down_blocks.{lvl}.downsamplers.0.conv")
    m.resnet("mid_res_0", "mid_block.resnets.0")
    m.resnet("mid_res_1", "mid_block.resnets.1")
    m.spatial_transformer("mid_attn", "mid_block.attentions.0", cfg.depth_at(n - 1), lin)
    for lvl in range(n):
        k = n - 1 - lvl  # diffusers up_blocks index
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"up_{lvl}_res_{j}", f"up_blocks.{k}.resnets.{j}")
            if cfg.cross_attention[lvl]:
                m.spatial_transformer(f"up_{lvl}_attn_{j}", f"up_blocks.{k}.attentions.{j}",
                                      cfg.depth_at(lvl), lin)
        if lvl > 0:
            m.conv(f"up_{lvl}_upsample/conv", f"up_blocks.{k}.upsamplers.0.conv")
    m.norm("conv_norm_out", "conv_norm_out")
    m.conv("conv_out", "conv_out")
    return dict(m)


def controlnet_name_map(cfg: UNetConfig) -> NameMap:
    """The JAX ControlNet tree -> diffusers ``ControlNetModel`` names: the
    encoder copy's entries are the UNet map's (the same module names on both
    sides), plus the conditioning embedding and the zero-conv heads."""
    from sonicdiffusionbayeslab_torch.models.controlnet import COND_EMBED_CHANNELS

    m = MapEntries({k: v for k, v in unet_name_map(cfg).items()
                    if k.split("/")[0] in ("conv_in", "time_embedding", "add_embedding")
                    or k.startswith(("down_", "mid_"))})
    m.conv("cond_embedding/conv_in", "controlnet_cond_embedding.conv_in")
    for j in range(2 * (len(COND_EMBED_CHANNELS) - 1)):
        m.conv(f"cond_embedding/blocks_{j}", f"controlnet_cond_embedding.blocks.{j}")
    m.conv("cond_embedding/conv_out", "controlnet_cond_embedding.conv_out")
    n = len(cfg.block_out_channels)
    n_skips = 1 + sum(cfg.layers_per_block + (lvl < n - 1) for lvl in range(n))
    for i in range(n_skips):
        m.conv(f"control_out_{i}", f"controlnet_down_blocks.{i}")
    m.conv("control_mid", "controlnet_mid_block")
    return dict(m)


def vae_name_map(n_levels: int, layers_per_block: int) -> NameMap:
    """The whole JAX VAE tree: the decoder and the encoder side."""
    m = MapEntries()
    m.conv("decoder/conv_in", "decoder.conv_in")
    m.resnet("decoder/mid_res_0", "decoder.mid_block.resnets.0")
    m.resnet("decoder/mid_res_1", "decoder.mid_block.resnets.1")
    m.attn_block2d("decoder/mid_attn", "decoder.mid_block.attentions.0")
    for i in range(n_levels):
        for j in range(layers_per_block + 1):
            m.resnet(f"decoder/up_{i}_res_{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n_levels - 1:
            m.conv(f"decoder/up_{i}_upsample/conv", f"decoder.up_blocks.{i}.upsamplers.0.conv")
    m.norm("decoder/norm_out", "decoder.conv_norm_out")
    m.conv("decoder/conv_out", "decoder.conv_out")
    m.conv("encoder/conv_in", "encoder.conv_in")
    for i in range(n_levels):
        for j in range(layers_per_block):
            m.resnet(f"encoder/down_{i}_res_{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n_levels - 1:
            m.conv(f"encoder/down_{i}_downsample/conv",
                   f"encoder.down_blocks.{i}.downsamplers.0.conv")
    m.resnet("encoder/mid_res_0", "encoder.mid_block.resnets.0")
    m.resnet("encoder/mid_res_1", "encoder.mid_block.resnets.1")
    m.attn_block2d("encoder/mid_attn", "encoder.mid_block.attentions.0")
    m.norm("encoder/norm_out", "encoder.conv_norm_out")
    m.conv("encoder/conv_out", "encoder.conv_out")
    m.conv("post_quant_conv", "post_quant_conv")
    m.conv("quant_conv", "quant_conv")
    return dict(m)


def clip_text_name_map(num_layers: int, src_prefix: str = "text_model",
                       dst_prefix: str = "") -> NameMap:
    m = MapEntries()
    p, d = src_prefix, (dst_prefix + "/" if dst_prefix else "")
    m[f"{d}token_embedding/embedding"] = (f"{p}.embeddings.token_embedding.weight", _id)
    m[f"{d}position_embedding"] = (f"{p}.embeddings.position_embedding.weight", _id)
    for i in range(num_layers):
        m.clip_layer(f"{d}layer_{i}", f"{p}.encoder.layers.{i}")
    m.norm(f"{d}final_ln", f"{p}.final_layer_norm")
    return dict(m)


def clip_dual_name_map(vision_layers: int, text_layers: int) -> NameMap:
    """The JAX ``CLIPDualEncoder`` tree -> transformers ``CLIPModel`` names
    (the CLIP score's dual encoder, ``models/clip_vision.py``)."""
    m = MapEntries(clip_text_name_map(text_layers, "text_model", "text"))
    p, d = "vision_model", "vision/"
    m[f"{d}patch_embedding/kernel"] = (f"{p}.embeddings.patch_embedding.weight", _conv)
    m[f"{d}class_embedding"] = (f"{p}.embeddings.class_embedding", _id)
    m[f"{d}position_embedding"] = (f"{p}.embeddings.position_embedding.weight", _id)
    m.norm(f"{d}pre_ln", f"{p}.pre_layrnorm")
    for i in range(vision_layers):
        m.clip_layer(f"{d}layer_{i}", f"{p}.encoder.layers.{i}")
    m.norm(f"{d}post_ln", f"{p}.post_layernorm")
    m.dense("visual_projection", "visual_projection", bias=False)
    m.dense("text_projection", "text_projection", bias=False)
    return dict(m)


def image_reward_name_map(vision_layers: int, text_layers: int) -> NameMap:
    """The JAX ``ImageRewardModel`` tree -> the published ImageReward-v1.0
    names (``metrics/image_reward_model.py``): timm's ViT under
    ``blip.visual_encoder``, transformers' BERT under
    ``blip.text_encoder.bert``, the head's ``mlp.layers.{0,2,4,6,7}``."""
    m = MapEntries()
    v = "blip.visual_encoder"
    m.conv("vision/patch_embed", f"{v}.patch_embed.proj")
    m["vision/cls_token"] = (f"{v}.cls_token", _id)
    m["vision/pos_embed"] = (f"{v}.pos_embed", _id)
    for i in range(vision_layers):
        d, s = f"vision/block_{i}", f"{v}.blocks.{i}"
        m.norm(f"{d}/ln1", f"{s}.norm1")
        m.norm(f"{d}/ln2", f"{s}.norm2")
        m.dense(f"{d}/qkv", f"{s}.attn.qkv")
        m.dense(f"{d}/proj", f"{s}.attn.proj")
        m.dense(f"{d}/fc1", f"{s}.mlp.fc1")
        m.dense(f"{d}/fc2", f"{s}.mlp.fc2")
    m.norm("vision/ln_final", f"{v}.norm")
    b = "blip.text_encoder.bert"
    m["text/word_embeddings/embedding"] = (f"{b}.embeddings.word_embeddings.weight", _id)
    m["text/position_embeddings"] = (f"{b}.embeddings.position_embeddings.weight", _id)
    m.norm("text/ln_embed", f"{b}.embeddings.LayerNorm")
    for i in range(text_layers):
        d, s = f"text/layer_{i}", f"{b}.encoder.layer.{i}"
        for mine, theirs in (("self_attn", "attention"), ("cross_attn", "crossattention")):
            for p in ("query", "key", "value"):
                m.dense(f"{d}/{mine}/{p}", f"{s}.{theirs}.self.{p}")
            m.dense(f"{d}/{mine}/out", f"{s}.{theirs}.output.dense")
        m.norm(f"{d}/ln_self", f"{s}.attention.output.LayerNorm")
        m.norm(f"{d}/ln_cross", f"{s}.crossattention.output.LayerNorm")
        m.dense(f"{d}/fc1", f"{s}.intermediate.dense")
        m.dense(f"{d}/fc2", f"{s}.output.dense")
        m.norm(f"{d}/ln_out", f"{s}.output.LayerNorm")
    for i, j in enumerate((0, 2, 4, 6)):
        m.dense(f"head/fc{i}", f"mlp.layers.{j}")
    m.dense("head/out", "mlp.layers.7")
    return dict(m)


def aesthetic_name_map() -> NameMap:
    """The JAX ``AestheticScoreMLP`` tree -> ``layers.{0,2,4,6,7}``."""
    m = MapEntries()
    for i, j in enumerate((0, 2, 4, 6)):
        m.dense(f"fc{i}", f"layers.{j}")
    m.dense("out", "layers.7")
    return dict(m)


_BN = {"bn_mean": "running_mean", "bn_var": "running_var", "bn_scale": "weight",
       "bn_bias": "bias"}


def inception_name_map(tree: dict) -> NameMap:
    """The JAX ``InceptionBlocks`` tree -> pytorch-fid's names: each
    conv + frozen BatchNorm at JAX path ``A/B`` is torch module ``A.B``
    (``.conv.weight``; ``.bn.running_mean``, ``.bn.running_var``,
    ``.bn.weight``, ``.bn.bias``)."""
    m = MapEntries()
    for path in flatten(tree):
        if path.endswith("/conv/kernel"):
            unit = path[: -len("/conv/kernel")]
            src = unit.replace("/", ".")
            m[f"{unit}/conv/kernel"] = (f"{src}.conv.weight", _conv)
            for jax_name, torch_name in _BN.items():
                m[f"{unit}/{jax_name}"] = (f"{src}.bn.{torch_name}", _id)
    return dict(m)


def mmdit_name_map(cfg) -> NameMap:
    """The JAX ``MMDiT`` tree -> diffusers ``SD3Transformer2DModel`` names.
    The JAX patch kernel [p * p * C, O] in (ph, pw, c) row order becomes
    ``pos_embed.proj``'s OIHW conv weight; the final block has no context
    output projection or feed-forward; the sincos table is not a
    parameter."""
    m = MapEntries()
    p = cfg.patch_size

    def patch(w):  # [ph * pw * C, O] -> [O, C, ph, pw]
        return np.asarray(w).reshape(p, p, -1, w.shape[-1]).transpose(3, 2, 0, 1)

    m["patch_proj/kernel"] = ("pos_embed.proj.weight", patch)
    m["patch_proj/bias"] = ("pos_embed.proj.bias", _id)
    for ours, theirs in (("timestep_embedder", "timestep_embedder"),
                         ("text_embedder", "text_embedder")):
        m.dense(f"{ours}/fc1", f"time_text_embed.{theirs}.linear_1")
        m.dense(f"{ours}/fc2", f"time_text_embed.{theirs}.linear_2")
    m.dense("context_embedder", "context_embedder")
    for i in range(cfg.depth):
        d, s = f"blocks_{i}", f"transformer_blocks.{i}"
        m.dense(f"{d}/norm1/linear", f"{s}.norm1.linear")
        m.dense(f"{d}/norm1_context/linear", f"{s}.norm1_context.linear")
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            m.dense(f"{d}/{proj}", f"{s}.attn.{proj}")
        m.dense(f"{d}/to_out", f"{s}.attn.to_out.0")
        if cfg.qk_norm:
            for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                m[f"{d}/{n}/scale"] = (f"{s}.attn.{n}.weight", _id)
        m.dense(f"{d}/ff/proj_in", f"{s}.ff.net.0.proj")
        m.dense(f"{d}/ff/proj_out", f"{s}.ff.net.2")
        if i < cfg.depth - 1:
            m.dense(f"{d}/to_add_out", f"{s}.attn.to_add_out")
            m.dense(f"{d}/ff_context/proj_in", f"{s}.ff_context.net.0.proj")
            m.dense(f"{d}/ff_context/proj_out", f"{s}.ff_context.net.2")
    m.dense("norm_out/linear", "norm_out.linear")
    m.dense("proj_out", "proj_out")
    return dict(m)


def t5_name_map(num_layers: int) -> NameMap:
    """The JAX ``T5Encoder`` tree -> transformers ``T5EncoderModel`` names;
    the shared relative-position table is block 0's."""
    m = MapEntries()
    m["token_embedding/embedding"] = ("shared.weight", _id)
    m["relative_attention_bias"] = (
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", _id)
    m["final_ln/scale"] = ("encoder.final_layer_norm.weight", _id)
    for i in range(num_layers):
        d, s = f"block_{i}", f"encoder.block.{i}"
        for p in "qkvo":
            m.dense(f"{d}/attn/{p}", f"{s}.layer.0.SelfAttention.{p}", bias=False)
        m[f"{d}/ln1/scale"] = (f"{s}.layer.0.layer_norm.weight", _id)
        for p in ("wi_0", "wi_1", "wo"):
            m.dense(f"{d}/{p}", f"{s}.layer.1.DenseReluDense.{p}", bias=False)
        m[f"{d}/ln2/scale"] = (f"{s}.layer.1.layer_norm.weight", _id)
    return dict(m)


def mmdit_geometry(tree: dict, patch_size: int = 2):
    """The name-map-relevant geometry of a JAX MMDiT tree (depth, q/k
    norms); the patch size does not show in the tree (SD3's is 2)."""
    from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig

    return MMDiTConfig(depth=_count(tree, "blocks_{}"), patch_size=patch_size,
                       qk_norm="norm_q" in tree["blocks_0"])


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in sd.items()}


def image_reward_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``ImageRewardModel`` tree (numpy leaves) -> the port's
    ``ImageRewardModel`` state dict (``strict=True``)."""
    return _tensors(invert(tree, image_reward_name_map(_count(tree["vision"], "block_{}"),
                                                       _count(tree["text"], "layer_{}"))))


def inception_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``InceptionBlocks`` tree -> the port's ``InceptionBlocks`` state
    dict at the same ``max_tap``."""
    return _tensors(invert(tree, inception_name_map(tree)))


def aesthetic_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``AestheticScoreMLP`` tree -> the port's ``AestheticScoreMLP``
    state dict."""
    return _tensors(invert(tree, aesthetic_name_map()))


def clip_dual_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``CLIPDualEncoder`` tree of any geometry (ViT-B/16, ViT-L/14,
    tiny) -> the port's ``CLIPDualEncoder`` state dict."""
    return _tensors(invert(tree, clip_dual_name_map(_count(tree["vision"], "layer_{}"),
                                                    _count(tree["text"], "layer_{}"))))


def flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def invert(tree: dict, name_map: NameMap) -> Dict[str, np.ndarray]:
    """JAX tree -> torch-layout state dict of fp32 numpy arrays."""
    out = {}
    for path, v in flatten(tree).items():
        name, fwd = name_map[path]
        out[name] = fwd(np.asarray(v, np.float32))
    return out


def _count(tree: dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in tree:
        n += 1
    return n


def unet_geometry(tree: dict) -> UNetConfig:
    """The name-map-relevant geometry that a JAX UNet tree shows (levels,
    widths, layers per block, which levels attend, transformer depth a
    level).  A JAX kernel is [in, out] whether the torch module is a linear
    or a 1x1 conv, so the tree cannot tell SD-2.x's linear projections from
    SD-1.5's convs: this geometry has SD-1.5's convs, or linears where the
    text_time ``add_embedding`` is present (SDXL; the JAX config's
    default), and the guidance embedding's width where ``cond_proj`` is.
    Head counts do not enter the names."""
    n = _count(tree, "down_{}_res_0")
    attn = [f"down_{i}_attn_0" for i in range(n)]
    depth = tuple(_count(tree[a], "block_{}") if a in tree else 1 for a in attn)
    depth = depth[:-1] + (_count(tree["mid_attn"], "block_{}"),)
    return UNetConfig(
        block_out_channels=tuple(tree[f"down_{i}_res_0"]["conv1"]["kernel"].shape[-1]
                                 for i in range(n)),
        layers_per_block=_count(tree, "down_0_res_{}"),
        cross_attention=tuple(a in tree for a in attn),
        transformer_depth=depth if len(set(depth)) > 1 else depth[0],
        use_linear_projection=True if "add_embedding" in tree else None,
        time_cond_proj_dim=(tree["time_embedding"]["cond_proj"]["kernel"].shape[0]
                            if "cond_proj" in tree["time_embedding"] else None),
    )


def state_dicts_from_jax(params_np: dict, unet_config=None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX engine's tree (numpy leaves) -> a state dict of fp32 tensors
    for each module that the port's modules load with ``strict=True``:
    ``{"unet", "vae", "text"}``, an SDXL tree's ``"text2"`` (its
    ``text2_proj`` kernel as ``text_projection.weight``), and an SD3 tree's
    MMDiT as ``"unet"``, both towers' projections (``text_proj``,
    ``text2_proj``) and its optional ``"t5"``.  The VAE keeps both sides (a
    tree without the encoder loads for decoding only).  ``unet_config``
    gives the UNet's projection layout (needed for SD-2.x) or the MMDiT's
    patch size; without it the tree's own geometry is used
    (``unet_geometry``, ``mmdit_geometry``)."""
    dec = params_np["vae"]["decoder"]
    vae = invert(params_np["vae"], vae_name_map(_count(dec, "up_{}_res_0"),
                                                _count(dec, "up_0_res_{}") - 1))
    tree = params_np["unet"]
    if "blocks_0" in tree:  # the MMDiT
        cfg = mmdit_geometry(tree, unet_config.patch_size if unet_config else 2)
        unet = invert(tree, mmdit_name_map(cfg))
    else:
        unet = invert(tree, unet_name_map(unet_config or unet_geometry(tree)))
    sds = {"unet": unet, "vae": vae}
    for key in ("text", "text2"):
        if key in params_np:
            sds[key] = invert(params_np[key],
                              clip_text_name_map(_count(params_np[key], "layer_{}")))
        if f"{key}_proj" in params_np:
            sds[key]["text_projection.weight"] = _lin(
                np.asarray(params_np[f"{key}_proj"]["kernel"], np.float32))
    if "t5" in params_np:
        sds["t5"] = invert(params_np["t5"], t5_name_map(_count(params_np["t5"], "block_{}")))
    if "image_proj" in params_np:  # IP-Adapter's projection
        m = MapEntries()
        m.dense("proj", "proj")
        m.norm("norm", "norm")
        sds["image_proj"] = invert(params_np["image_proj"], dict(m))
    return {k: _tensors(sd) for k, sd in sds.items()}


def controlnet_state_dict_from_jax(tree: dict, unet_config=None) -> Dict[str, torch.Tensor]:
    """The JAX ControlNet tree -> the port's ``ControlNet`` state dict
    (``unet_config`` as in :func:`state_dicts_from_jax`; without it the
    geometry of the encoder copy)."""
    return _tensors(invert(tree, controlnet_name_map(unet_config or unet_geometry(tree))))


def _adapter_items(tree: dict, prefix: str = ""):
    """(JAX module path, {"a", "b"}) of each adapter in a JAX LoRA tree."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) and set(v) == {"a", "b"}:
            yield path, v
        elif isinstance(v, dict):
            yield from _adapter_items(v, path)


def _lora_from_jax(adapters: dict, name_map: NameMap) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for path, node in _adapter_items(adapters):
        name = name_map[path][0]  # the path ends in the kernel's own "/kernel"
        out[name[: -len(".weight")]] = {k: torch.from_numpy(np.array(node[k], np.float32))
                                         for k in ("a", "b")}
    return out


def lora_from_jax(adapters: dict, unet_config=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX UNet LoRA tree (``training/lora.py::init_lora``'s, numpy
    leaves) -> the port's adapters: keyed by the module's torch name
    through ``unet_name_map`` (``unet_config``: the UNet's levels and
    depth, default SD-1.5's), each ``{"a": [in, r], "b": [r, out]}`` in
    fp32 as JAX keeps them."""
    return _lora_from_jax(adapters, unet_name_map(unet_config or UNetConfig.sd15()))


def mmdit_lora_from_jax(adapters: dict, mmdit_config=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """:func:`lora_from_jax` for a JAX MMDiT LoRA tree, through
    ``mmdit_name_map`` (``mmdit_config`` default: the adapters' own depth)."""
    return _lora_from_jax(adapters, mmdit_name_map(mmdit_config or mmdit_geometry(adapters)))


def trainable_from_jax(tree, unet_config=None):
    """The trainable (or EMA) tree of a JAX ``TrainState``, numpy leaves, as
    the port's trainers hold it: LoRA adapters (:func:`lora_from_jax`), a
    full UNet tree (a state dict through ``unet_name_map``, a w-conditioned
    student's ``cond_proj`` included) or textual inversion's [k, C] rows
    (one tensor); all fp32.  ``unet_config`` as in :func:`lora_from_jax`
    (default: the tree's own geometry for a full tree, SD-1.5 for LoRA)."""
    if not isinstance(tree, dict):
        return torch.from_numpy(np.array(tree, np.float32))
    if next(_adapter_items(tree), None) is not None:
        return lora_from_jax(tree, unet_config)
    return _tensors(invert(tree, unet_name_map(unet_config or unet_geometry(tree))))


# ------------------------------------------------------- local checkpoints
# Keys a checkpoint may carry that the port's modules have no parameter
# for: transformers' position-id buffers and CLIPModel's logit scale (the
# score does not use it).
_CLIP_EXTRA = ("text_model.embeddings.position_ids", "vision_model.embeddings.position_ids",
               "logit_scale")


def load_torch_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """A ``.bin`` (torch pickle, loaded with ``weights_only=True``) or a
    ``.safetensors`` file -> {name: CPU tensor}."""
    path = Path(path)
    if path.suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError("safetensors not installed; use a .bin checkpoint") from e
        return dict(load_file(str(path)))
    return dict(torch.load(str(path), map_location="cpu", weights_only=True))


def _find_checkpoint(d: Path, names) -> Path:
    for name in names:
        if (d / name).exists():
            return d / name
    raise FileNotFoundError(f"no checkpoint under {d} (looked for {', '.join(names)})")


def _load_strict(module: nn.Module, sd: Dict[str, torch.Tensor], drop, what: str) -> None:
    """Load ``sd`` minus the keys ``drop(name)`` selects, strictly: any other
    extra or missing key raises."""
    sd = {k: v for k, v in sd.items() if not drop(k)}
    try:
        module.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"{what}: {e}") from None


def load_clip_checkpoint(snapshot_dir: str | Path, model: nn.Module) -> nn.Module:
    """A transformers ``CLIPModel`` snapshot dir (``pytorch_model.bin`` or
    ``model.safetensors``) into the port's ``CLIPDualEncoder``."""
    snapshot_dir = Path(snapshot_dir)
    path = _find_checkpoint(snapshot_dir, ("pytorch_model.bin", "model.safetensors"))
    _load_strict(model, load_torch_state_dict(path), lambda k: k in _CLIP_EXTRA, str(path))
    return model


# A fused projection's sources in diffusers' separate layout, in the order
# of its rows.
FUSED_SOURCES = {"to_qkv": ("to_q", "to_k", "to_v"), "to_kv": ("to_k", "to_v")}


def _fused_parts(name: str):
    """(module prefix with its dot, fused projection) of a fused weight's
    name, else (None, None)."""
    mod, _, proj = name.removesuffix(".weight").rpartition(".")
    if not name.endswith(".weight") or proj not in FUSED_SOURCES:
        return None, None
    return (f"{mod}." if mod else ""), proj


def fuse_projections(sd: Dict[str, torch.Tensor], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``sd`` (diffusers' separate ``to_q``/``to_k``/``to_v`` weights) for a
    ``module`` built with ``fused_qkv``: each of the module's ``to_qkv``
    and ``to_kv`` weights that ``sd`` lacks is its sources concatenated on
    the output rows (q, then k, then v), the sources dropped.  A state dict
    already fused, or a module that is not, passes unchanged."""
    out = dict(sd)
    for name in module.state_dict():
        mod, proj = _fused_parts(name)
        if proj is None or name in out:
            continue
        srcs = [f"{mod}{p}.weight" for p in FUSED_SOURCES[proj]]
        if all(k in out for k in srcs):
            out[name] = torch.cat([out.pop(k) for k in srcs], dim=0)
    return out


def _refuse_fused_vae(engine, module: nn.Module, d: Path) -> None:
    """Raise KeyError at a fused VAE (what is loaded so far stays loaded)."""
    if module is engine.vae and getattr(module, "fused_qkv", False):
        engine.weights_changed()
        raise KeyError(f"{d}: a VAE with fused q/k/v projections (fused_qkv, SDBL_FUSED_QKV=1) "
                       "loads no diffusers checkpoint: the VAE name map has no fused entry, as "
                       "in the JAX package")


def load_sd_checkpoint(snapshot_dir: str | Path, engine) -> None:
    """A diffusers-layout SD snapshot dir (``unet/``, ``vae/``,
    ``text_encoder/``; an SDXL snapshot also ``text_encoder_2/``, a
    ``CLIPTextModelWithProjection``) into ``engine``'s modules.  The text
    encoders' ``position_ids`` buffers are dropped by name; a VAE without
    its encoder's keys loads for decoding only (``AutoencoderKL.
    has_encoder``); any other extra or missing key raises.  A fused UNet
    (``fused_qkv``) takes the checkpoint's projections concatenated
    (:func:`fuse_projections`).  A fused VAE takes none: the VAE name map
    has no fused entry, as in the JAX package, whose conversion of such a
    snapshot fails at the VAE after the UNet's; here the UNet is loaded
    and then KeyError raised."""
    snapshot_dir = Path(snapshot_dir)
    names = ("diffusion_pytorch_model.bin", "pytorch_model.bin",
             "diffusion_pytorch_model.safetensors", "model.safetensors")
    parts = [("unet", engine.unet, lambda k: False),
             ("vae", engine.vae, lambda k: False),
             ("text_encoder", engine.text, lambda k: k in _CLIP_EXTRA)]
    if hasattr(engine, "text2"):
        parts.append(("text_encoder_2", engine.text2, lambda k: k in _CLIP_EXTRA))
    for sub, module, drop in parts:
        _refuse_fused_vae(engine, module, snapshot_dir / sub)
        path = _find_checkpoint(snapshot_dir / sub, names)
        sd = load_torch_state_dict(path)
        _load_strict(module, fuse_projections(sd, module), drop, str(path))
    engine.weights_changed()


# Keys of a diffusers SD3 snapshot with no parameter in the port: the
# transformer's fixed sincos table (recomputed) and T5's tied copy of its
# token embedding.
_SD3_EXTRA = {"transformer": ("pos_embed.pos_embed",),
              "text_encoder_3": ("encoder.embed_tokens.weight",)}
_CHECKPOINT_NAMES = ("diffusion_pytorch_model.bin", "pytorch_model.bin",
                     "diffusion_pytorch_model.safetensors", "model.safetensors")
# Each module's directory in a diffusers snapshot, and its file name.
_SNAPSHOT_DIRS = {"unet": ("unet", "diffusion_pytorch_model.bin"),
                  "vae": ("vae", "diffusion_pytorch_model.bin"),
                  "text": ("text_encoder", "pytorch_model.bin"),
                  "text2": ("text_encoder_2", "pytorch_model.bin"),
                  "t5": ("text_encoder_3", "pytorch_model.bin")}


def _load_dir(d: Path) -> Dict[str, torch.Tensor]:
    """The state dict under a snapshot directory: one checkpoint file, or
    the shards a ``*.index.json`` lists (transformers' sharded layout)."""
    for index in sorted(d.glob("*.index.json")):
        shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        sd = {}
        for shard in shards:
            sd.update(load_torch_state_dict(d / shard))
        return sd
    return load_torch_state_dict(_find_checkpoint(d, _CHECKPOINT_NAMES))


def load_sd3_checkpoint(snapshot_dir: str | Path, engine) -> None:
    """A diffusers SD3 snapshot dir (``transformer/`` the MMDiT, ``vae/``,
    ``text_encoder/`` and ``text_encoder_2/`` both
    ``CLIPTextModelWithProjection``, and ``text_encoder_3/`` T5 only when
    the engine has T5) into an ``SD3Engine``, strictly: the keys the port
    recomputes or ties (``_SD3_EXTRA``) and the towers' position ids are
    dropped by name, any other extra or missing key raises."""
    snapshot_dir = Path(snapshot_dir)
    parts = [("transformer", engine.unet, _SD3_EXTRA["transformer"]),
             ("vae", engine.vae, ()), ("text_encoder", engine.text, _CLIP_EXTRA),
             ("text_encoder_2", engine.text2, _CLIP_EXTRA)]
    if getattr(engine, "t5", None) is not None:
        parts.append(("text_encoder_3", engine.t5, _SD3_EXTRA["text_encoder_3"]))
    for sub, module, extra in parts:
        d = snapshot_dir / sub
        _refuse_fused_vae(engine, module, d)
        _load_strict(module, _load_dir(d), lambda k, extra=extra: k in extra, str(d))
    engine.weights_changed()


def write_snapshot(engine, snapshot_dir: str | Path) -> Path:
    """Each of the engine's modules into a diffusers-layout snapshot dir
    (``torch.save`` of its state dict, the MMDiT under ``transformer/``),
    which ``load_sd_checkpoint``/``load_sd3_checkpoint`` read back."""
    root = Path(snapshot_dir)
    for key, module in zip(engine.MODULES, engine.modules()):
        sub, name = _SNAPSHOT_DIRS[key]
        if key == "unet" and hasattr(module, "transformer_blocks"):
            sub = "transformer"
        (root / sub).mkdir(parents=True, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, root / sub / name)
    return root


def load_controlnet_checkpoint(snapshot_dir: str | Path, engine) -> None:
    """A diffusers ControlNet snapshot dir (``diffusion_pytorch_model.bin``
    or ``.safetensors``) into the engine's ``controlnet``, strictly."""
    d = Path(snapshot_dir)
    sd = load_torch_state_dict(_find_checkpoint(d, _CHECKPOINT_NAMES))
    _load_strict(engine.controlnet, fuse_projections(sd, engine.controlnet), lambda k: False,
                 str(d))
    engine.weights_changed()


def load_sdxl_checkpoint(snapshot_dir: str | Path, engine) -> None:
    """A diffusers SDXL snapshot dir (``unet/``, ``vae/``, ``text_encoder/``
    CLIP ViT-L, ``text_encoder_2/`` OpenCLIP bigG with its
    ``text_projection``) into an ``SDXLEngine``, strictly."""
    if not hasattr(engine, "text2"):
        raise TypeError("load_sdxl_checkpoint needs an engine with a second text tower "
                        "(SDXLEngine)")
    load_sd_checkpoint(snapshot_dir, engine)


# ------------------------------------------------------------------- LoRA
def merge_lora(unet_sd: Dict[str, torch.Tensor], lora_sd: Dict[str, torch.Tensor],
               scale: float = 1.0) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Fuse a diffusers-format UNet LoRA into the port's UNet state dict.

    The port's counterpart of ``sonicdiffusionbayeslab_tpu/models/weights.py::
    merge_lora``.  Keys are kohya's ``lora_unet_<module>.lora_down.weight`` /
    ``.lora_up.weight`` (with an optional ``.alpha``) or peft's
    ``unet.<module>.lora_A.weight`` / ``.lora_B.weight``; each module's
    weight gains ``up @ down * (alpha / rank) * scale`` (a conv LoRA's
    ``[r, in, kh, kw]`` down and ``[out, r, 1, 1]`` up likewise), summed in
    fp32 and cast back to the weight's dtype.  Kohya turns the module
    name's dots into underscores; the names are recovered by matching
    against the state dict's own.  In a fused UNet (``to_qkv``, ``to_kv``)
    a LoRA of ``to_q``, ``to_k`` or ``to_v`` adds to its rows of the fused
    weight (the JAX package adds to its columns of the fused kernel).
    Returns the merged state dict and the merged modules' names; raises
    when nothing matched."""
    fused = {}  # a fused weight's source module -> (its name, row section, sections)
    for k in unet_sd:
        mod, proj = _fused_parts(k)
        for slot, src in enumerate(FUSED_SOURCES.get(proj, ())):
            fused[f"{mod}{src}"] = (k, slot, len(FUSED_SOURCES[proj]))
    bases = [k[: -len(".weight")] for k in unet_sd if k.endswith(".weight")] + list(fused)
    demangle = {b.replace(".", "_"): b for b in bases}
    pairs: Dict[str, dict] = {}
    for k, v in lora_sd.items():
        if k.startswith("lora_unet_"):
            base = demangle.get(k[len("lora_unet_"):].split(".", 1)[0])
            if base is None:
                continue
            slot = {"lora_down": "down", "lora_up": "up"}.get(k.rsplit(".", 2)[-2])
        elif k.startswith("unet."):
            stripped = k[len("unet."):]
            if stripped.endswith(".alpha"):  # peft's alpha has no .lora_ marker
                base = stripped[: -len(".alpha")]
            else:
                base = stripped.rsplit(".lora_", 1)[0]
            slot = "down" if ".lora_A." in k else ("up" if ".lora_B." in k else None)
        else:
            continue
        if k.endswith(".alpha"):
            pairs.setdefault(base, {})["alpha"] = float(v)
        elif slot:
            pairs.setdefault(base, {})[slot] = torch.as_tensor(v).float()

    merged = dict(unet_sd)
    applied = []
    for base, p in pairs.items():
        name = f"{base}.weight"
        if "down" not in p or "up" not in p or (name not in unet_sd and base not in fused):
            continue
        down, up = p["down"], p["up"]
        rank = down.shape[0]
        if down.dim() == 4:  # conv LoRA
            delta = torch.einsum("or,rikl->oikl", up[:, :, 0, 0], down)
        else:
            delta = up @ down
        delta = delta * (p.get("alpha", float(rank)) / rank) * scale
        if name not in unet_sd:  # a source of a fused weight: its row section
            name, slot, sections = fused[base]
            w = merged[name].to(torch.float32, copy=True)
            rows = w.shape[0] // sections
            w[slot * rows:(slot + 1) * rows] += delta.to(w.device)
            merged[name] = w.to(unet_sd[name].dtype)
        else:
            w = unet_sd[name]
            merged[name] = (w.float() + delta.reshape(w.shape).to(w.device)).to(w.dtype)
        applied.append(base)
    if not applied:
        raise KeyError("no LoRA tensors matched the UNet's parameter names")
    return merged, sorted(applied)
