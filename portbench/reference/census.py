"""The work of the reference networks, counted from shapes on the meta
device: FLOPs (``FlopCounterMode`` for convolutions and matmuls, attention's
two products included, plus 10 operations an element for a GroupNorm with
SiLU and 6 without), and the shape of every attention and GroupNorm call.
No weight is made and no device is touched.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets
from portbench.reference.sample import build_nets


class Census:
    """What one forward of a network did: ``flops``, and ``calls``, a
    Counter of (kind, shape) with kind "attention" (shape (B, N, M, H, D,
    causal)) or "group_norm" (shape (B, N, C, groups, silu))."""

    def __init__(self):
        self.flops = 0
        self.calls: collections.Counter = collections.Counter()

    def hook(self, module, args, kwargs, _out):
        x = args[0]
        if isinstance(module, nets.GroupNorm):
            B, C = x.shape[0], x.shape[1]
            n = x[0, 0].numel()
            self.calls[("group_norm", (B, n, C, module.groups, module.silu))] += 1
            self.flops += (10 if module.silu else 6) * x.numel()
        else:
            ctx = args[1] if len(args) > 1 and args[1] is not None else x
            if isinstance(module, nets.VAEAttention):
                B, C, H, W = x.shape
                n = m = H * W
            else:
                B, n, _ = x.shape
                m = ctx.shape[1]
            causal = bool(kwargs.get("causal", False))
            self.calls[("attention", (B, n, m, module.heads, module.head_dim, causal))] += 1


def count(module: torch.nn.Module, *args, **kwargs) -> Census:
    """Run ``module`` (on the meta device) on ``args`` and count its work."""
    census = Census()
    handles = [m.register_forward_hook(census.hook, with_kwargs=True) for m in module.modules()
               if isinstance(m, (nets.GroupNorm, nets.Attention))]
    try:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    census.flops += int(fc.get_total_flops())
    return census


def pipeline_census(config: Dict, unet_rows: int, decode_rows: int,
                    text_rows: int = 1) -> Dict[str, Census]:
    """The census of one UNet call at ``unet_rows`` rows, one VAE decode of
    ``decode_rows`` latents and one encode of ``text_rows`` prompts by each
    text tower, at the configuration's image size."""
    models = build_nets(config, device="meta")
    p = config["pipeline"]
    lat = int(p["image_size"]) // 8
    unet = models["unet"]
    meta = dict(device="meta")
    ucfg = config["modules"]["unet"]["config"]
    ctx_dim = ucfg["cross_attention_dim"]
    T = config["modules"][p["text_towers"][0]]["config"]["max_position_embeddings"]
    added = {}
    if p["conditioning"] == "sdxl":
        pooled = ucfg["projection_class_embeddings_input_dim"] - 6 * ucfg["addition_time_embed_dim"]
        added = {"pooled": torch.empty(unet_rows, pooled, **meta),
                 "time_ids": torch.empty(unet_rows, 6, **meta)}
    out = {"unet": count(unet, torch.empty(unet_rows, unet.conv_in.in_channels, lat, lat, **meta),
                         torch.empty(unet_rows, **meta),
                         torch.empty(unet_rows, T, ctx_dim, **meta), **added)}
    vae = models["vae"]
    out["vae"] = count(vae, torch.empty(decode_rows, vae.post_quant_conv.in_channels, lat, lat,
                                        **meta))
    for name in p["text_towers"]:
        ids = torch.zeros(text_rows, T, dtype=torch.long, device="meta")
        out[name] = count(models[name], ids)
    return out


def offline_call_census(config: Dict, batch: int, steps: int,
                        microbatch: int) -> Tuple[float, List[Tuple[Census, int]]]:
    """(FLOPs an image, [(census, launches a call)]) of one CFG pipeline
    call of ``batch`` prompts: ``steps`` steps of the CFG-doubled batch in
    ``microbatch`` chunks, one decode of the batch, each prompt encoded
    once by each tower (the negative prompt's states are the same for
    every image, and are not counted)."""
    chunks = max(1, microbatch)
    rows = 2 * batch // chunks
    per_call = pipeline_census(config, rows, batch)
    per_row = pipeline_census(config, 1, 1)
    towers = config["pipeline"]["text_towers"]
    flops = (2 * steps * per_row["unet"].flops + per_row["vae"].flops
             + sum(per_row[t].flops for t in towers))
    parts = [(per_call["unet"], steps * chunks), (per_call["vae"], 1)]
    return float(flops), parts


def train_step_census(config: Dict, mix: Dict) -> float:
    """FLOPs of one LoRA step at the mix's batch: the UNet's forward with
    the adapted weights merged, and the backward to the adapters (input
    gradients through every layer, the adapters' own), on the meta device.
    The optimizer's and the EMA's elementwise work is not counted."""
    from torch.func import functional_call

    from portbench.reference.train import target_names

    unet = build_nets(config, device="meta")["unet"].requires_grad_(False)
    B = int(mix["batch"])
    r = int(mix["train"]["lora_rank"])
    lat = int(config["pipeline"]["image_size"]) // 8
    ucfg = config["modules"]["unet"]["config"]
    T = config["modules"]["text"]["config"]["max_position_embeddings"]
    params = dict(unet.named_parameters())
    adapters = {}
    for n in target_names(unet):
        d_out, d_in = params[f"{n}.weight"].shape
        adapters[n] = (torch.empty(d_in, r, device="meta", requires_grad=True),
                       torch.empty(r, d_out, device="meta", requires_grad=True))
    with FlopCounterMode(display=False) as fc:
        merged = {f"{n}.weight": params[f"{n}.weight"] + (a @ b).t()
                  for n, (a, b) in adapters.items()}
        x = torch.empty(B, ucfg["in_channels"], lat, lat, device="meta")
        out = functional_call(unet, merged, (x, torch.empty(B, device="meta"),
                                             torch.empty(B, T, ucfg["cross_attention_dim"],
                                                         device="meta")), strict=False)
        loss = (out ** 2).mean()
        torch.autograd.grad(loss, [t for ab in adapters.values() for t in ab])
    gn = count(unet, x, torch.empty(B, device="meta"),
               torch.empty(B, T, ucfg["cross_attention_dim"], device="meta"))
    gn_elementwise = sum((10 if s[4] else 6) * s[0] * s[1] * s[2] * n
                         for (k, s), n in gn.calls.items() if k == "group_norm")
    return float(fc.get_total_flops() + gn_elementwise)
