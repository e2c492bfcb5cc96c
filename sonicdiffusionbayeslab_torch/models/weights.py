"""JAX parameter trees and local checkpoints -> the port's modules.

The port's own copies of the name maps in
``sonicdiffusionbayeslab_tpu/models/weights.py`` (``unet_name_map``,
``vae_name_map``, ``clip_text_name_map``, ``clip_dual_name_map``) and of
``invert``: for every JAX parameter path, the diffusers / transformers
tensor name and the layout change (HWIO conv -> OIHW, [in, out] dense ->
[out, in], dense -> [out, in, 1, 1] for SD-1.5's 1x1-conv transformer
projections).  The metric towers' maps follow the JAX package's loaders
of the published files (``image_reward_name_map``: ImageReward-v1.0's
names; ``inception_name_map``: pytorch-fid's; ``aesthetic_name_map``:
the LAION head's), and ``*_from_jax`` turn those JAX trees into the
port's state dicts.  The port's modules carry exactly those names, so a local
diffusers snapshot or transformers CLIP checkpoint loads by name
(``load_sd_checkpoint``, ``load_clip_checkpoint``), strictly, after
dropping by name the few keys the port's modules do not have.
"""

from __future__ import annotations

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
        for p in ("to_q", "to_k", "to_v"):
            self.dense(f"{dst}/{p}", f"{src}.{p}", bias=False)
        self.dense(f"{dst}/to_out", f"{src}.to_out.0")

    def transformer_block(self, dst, src):
        self.attention(f"{dst}/attn1", f"{src}.attn1")
        self.attention(f"{dst}/attn2", f"{src}.attn2")
        self.dense(f"{dst}/ff/proj_in", f"{src}.ff.net.0.proj")
        self.dense(f"{dst}/ff/proj_out", f"{src}.ff.net.2")
        for i in (1, 2, 3):
            self.norm(f"{dst}/norm{i}", f"{src}.norm{i}")

    def spatial_transformer(self, dst, src, depth):
        self.norm(f"{dst}/norm", f"{src}.norm")
        for p in ("proj_in", "proj_out"):  # SD-1.5: 1x1 convs
            self[f"{dst}/{p}/kernel"] = (f"{src}.{p}.weight", _dense_to_conv1x1)
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
    depth = cfg.transformer_depth
    m.conv("conv_in", "conv_in")
    m.dense("time_embedding/fc1", "time_embedding.linear_1")
    m.dense("time_embedding/fc2", "time_embedding.linear_2")
    n = len(cfg.block_out_channels)
    for lvl in range(n):
        for j in range(cfg.layers_per_block):
            m.resnet(f"down_{lvl}_res_{j}", f"down_blocks.{lvl}.resnets.{j}")
            if cfg.cross_attention[lvl]:
                m.spatial_transformer(f"down_{lvl}_attn_{j}",
                                      f"down_blocks.{lvl}.attentions.{j}", depth)
        if lvl < n - 1:
            m.conv(f"down_{lvl}_downsample/conv", f"down_blocks.{lvl}.downsamplers.0.conv")
    m.resnet("mid_res_0", "mid_block.resnets.0")
    m.resnet("mid_res_1", "mid_block.resnets.1")
    m.spatial_transformer("mid_attn", "mid_block.attentions.0", depth)
    for lvl in range(n):
        k = n - 1 - lvl  # diffusers up_blocks index
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"up_{lvl}_res_{j}", f"up_blocks.{k}.resnets.{j}")
            if cfg.cross_attention[lvl]:
                m.spatial_transformer(f"up_{lvl}_attn_{j}", f"up_blocks.{k}.attentions.{j}", depth)
        if lvl > 0:
            m.conv(f"up_{lvl}_upsample/conv", f"up_blocks.{k}.upsamplers.0.conv")
    m.norm("conv_norm_out", "conv_norm_out")
    m.conv("conv_out", "conv_out")
    return dict(m)


def vae_name_map(n_levels: int, layers_per_block: int) -> NameMap:
    """Encoder entries included, so the whole JAX VAE tree inverts; the
    port's ``AutoencoderKL`` keeps only the decoder side."""
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
    """The name-map-relevant geometry of a JAX UNet tree (levels, widths,
    layers per block, which levels attend, transformer depth)."""
    n = _count(tree, "down_{}_res_0")
    return UNetConfig(
        block_out_channels=tuple(tree[f"down_{i}_res_0"]["conv1"]["kernel"].shape[-1]
                                 for i in range(n)),
        layers_per_block=_count(tree, "down_0_res_{}"),
        cross_attention=tuple(f"down_{i}_attn_0" in tree for i in range(n)),
        transformer_depth=_count(tree["mid_attn"], "block_{}"),
    )


def state_dicts_from_jax(params_np: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX engine's ``{"unet", "vae", "text"}`` tree (numpy leaves) ->
    ``{"unet", "vae", "text"}`` state dicts of fp32 tensors that the port's
    modules load with ``strict=True``.  The VAE keeps its decoder side."""
    dec = params_np["vae"]["decoder"]
    vae = invert(params_np["vae"], vae_name_map(_count(dec, "up_{}_res_0"),
                                                _count(dec, "up_0_res_{}") - 1))
    vae = {k: v for k, v in vae.items() if not k.startswith(("encoder.", "quant_conv."))}
    sds = {
        "unet": invert(params_np["unet"], unet_name_map(unet_geometry(params_np["unet"]))),
        "vae": vae,
        "text": invert(params_np["text"],
                       clip_text_name_map(_count(params_np["text"], "layer_{}"))),
    }
    return {k: {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in sd.items()}
            for k, sd in sds.items()}


# ------------------------------------------------------- local checkpoints
# Keys a checkpoint may carry that the port's modules have no parameter
# for: transformers' position-id buffers and CLIPModel's logit scale (the
# score does not use it), and a full diffusers VAE's encoder side.
_CLIP_EXTRA = ("text_model.embeddings.position_ids", "vision_model.embeddings.position_ids",
               "logit_scale")
_VAE_ENCODER = ("encoder.", "quant_conv.")


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


def load_sd_checkpoint(snapshot_dir: str | Path, engine) -> None:
    """A diffusers-layout SD snapshot dir (``unet/``, ``vae/``,
    ``text_encoder/``) into ``engine``'s modules.  The VAE's encoder keys
    and the text encoder's ``position_ids`` buffer are dropped by name; any
    other extra or missing key raises."""
    snapshot_dir = Path(snapshot_dir)
    names = ("diffusion_pytorch_model.bin", "pytorch_model.bin",
             "diffusion_pytorch_model.safetensors", "model.safetensors")
    parts = (("unet", engine.unet, lambda k: False),
             ("vae", engine.vae, lambda k: k.startswith(_VAE_ENCODER)),
             ("text_encoder", engine.text, lambda k: k in _CLIP_EXTRA))
    for sub, module, drop in parts:
        path = _find_checkpoint(snapshot_dir / sub, names)
        _load_strict(module, load_torch_state_dict(path), drop, str(path))
    engine.graphed_unet.clear()


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
    against the state dict's own.  Returns the merged state dict and the
    merged modules' names; raises when nothing matched."""
    demangle = {k[: -len(".weight")].replace(".", "_"): k[: -len(".weight")]
                for k in unet_sd if k.endswith(".weight")}
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
        if "down" not in p or "up" not in p or name not in unet_sd:
            continue
        down, up = p["down"], p["up"]
        rank = down.shape[0]
        if down.dim() == 4:  # conv LoRA
            delta = torch.einsum("or,rikl->oikl", up[:, :, 0, 0], down)
        else:
            delta = up @ down
        delta = delta * (p.get("alpha", float(rank)) / rank) * scale
        w = unet_sd[name]
        merged[name] = (w.float() + delta.reshape(w.shape).to(w.device)).to(w.dtype)
        applied.append(base)
    if not applied:
        raise KeyError("no LoRA tensors matched the UNet's parameter names")
    return merged, sorted(applied)
