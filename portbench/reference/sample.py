"""The plain reference of one text-to-image pipeline call: the offline
hash tokenizer, each sample's initial latents from (seed, index), the text
tower(s), classifier-free guidance, DPM-Solver++ of order 2 (multistep,
midpoint, diffusers' ``DPMSolverMultistepScheduler`` with
``lower_order_final`` and a final sigma of zero), the VAE decode and the
[0, 1] clamp.

Written from the published algorithms and the configuration files'
``pipeline`` section; it imports nothing of the port.  The reference
computes in float32 with TF32 off (``fp32_exact``).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import nets


class HashTokenizer:
    """The configurations' assumed tokenizer (no vocabulary file is in the
    repository): each lower-cased whitespace-separated word's FNV-1a hash
    modulo ``vocab_size - 2``, between a start id (``vocab_size - 2``) and
    an end id (``vocab_size - 1``), which also pads to ``max_length``."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size, self.max_length = vocab_size, max_length

    def word_ids(self, text: str) -> List[int]:
        ids = []
        for word in re.findall(r"\S+", text.lower()):
            h = 2166136261
            for c in word.encode("utf-8"):
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        bos, eos = self.vocab_size - 2, self.vocab_size - 1
        out = np.full((len(texts), self.max_length), eos, dtype=np.int64)
        for i, t in enumerate(texts):
            ids = [bos] + self.word_ids(t)[: self.max_length - 2] + [eos]
            out[i, : len(ids)] = ids
        return out


def initial_latents(seed: int, index: int, channels: int, h: int, w: int) -> torch.Tensor:
    """Sample ``index``'s standard normal start latents [C, h, w] on the CPU:
    a CPU ``torch.Generator`` seeded with the first 63 bits of numpy's
    ``SeedSequence([seed, index])``, drawing an [h, w, C] map."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device="cpu").manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)
    return torch.randn((h, w, channels), generator=gen, dtype=torch.float32).permute(2, 0, 1)


class DPMSolverPP2M:
    """DPM-Solver++(2M): the ladder of a ``steps``-step run on the training
    schedule (``beta_schedule`` scaled_linear, "leading" spacing with
    ``steps_offset``), first and last steps of order 1."""

    def __init__(self, sched: Dict, steps: int):
        T = int(sched["num_train_timesteps"])
        betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, T,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        ratio = T // steps
        self.timesteps = (np.arange(steps) * ratio)[::-1] + int(sched["steps_offset"])
        sig = np.sqrt((1.0 - acp[self.timesteps]) / acp[self.timesteps])
        self.sigmas = np.concatenate([sig, [0.0]])
        self.alpha = 1.0 / np.sqrt(self.sigmas ** 2 + 1.0)
        self.sigma_t = self.sigmas * self.alpha
        with np.errstate(divide="ignore"):
            self.lam = np.log(self.alpha) - np.log(self.sigma_t)

    def run(self, x: torch.Tensor, eps_fn) -> torch.Tensor:
        """``eps_fn(x, timestep) -> eps`` (guidance applied); x fp32."""
        L = len(self.timesteps)
        prev_x0 = None
        for i, t in enumerate(self.timesteps):
            eps = eps_fn(x, float(t))
            x0 = (x - self.sigma_t[i] * eps) / self.alpha[i]
            if i == L - 1:  # final sigma 0: the step lands on the data prediction
                x = x0
                break
            h = self.lam[i + 1] - self.lam[i]
            em1 = np.expm1(-h)
            d = x0
            if i > 0:  # order 2 (midpoint): D = x0 + (x0 - x0_prev) / (2 r0)
                r0 = (self.lam[i] - self.lam[i - 1]) / h
                d = x0 + (x0 - prev_x0) / (2.0 * r0)
            x = (self.sigma_t[i + 1] / self.sigma_t[i]) * x - self.alpha[i + 1] * em1 * d
            prev_x0 = x0
        return x


@contextlib.contextmanager
def fp32_exact():
    """Float32 matmuls and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def build_nets(config: Dict, device="cpu") -> Dict[str, torch.nn.Module]:
    """The configuration's networks, named as ``config["modules"]`` names
    them: a ``UNet``, a ``VAEDecoder`` and one ``CLIPText`` for each text
    tower (the second of SDXL's with its projection)."""
    out = {}
    with torch.device(device):
        for name, spec in config["modules"].items():
            kind, cfg = spec["kind"], spec["config"]
            if kind == "unet":
                out[name] = nets.UNet(cfg)
            elif kind == "vae":
                out[name] = nets.VAEDecoder(cfg)
            elif kind == "clip_text":
                out[name] = nets.CLIPText(cfg, projection=bool(spec.get("projection")))
            else:
                raise ValueError(f"unknown module kind {kind!r}")
    return out


class Pipeline:
    """The reference call: ``images(prompts, seed, indices)`` gives images
    [n, H, W, 3] in [0, 1] (fp32) of the prompts, sample ``indices[i]`` of a
    call with ``seed`` each.  ``models``: ``build_nets``' networks in
    float32 with the benchmark's weights loaded."""

    def __init__(self, config: Dict, models: Dict[str, torch.nn.Module]):
        self.config, self.models = config, models
        p = config["pipeline"]
        self.size = int(p["image_size"])
        self.towers = [(name, HashTokenizer(config["modules"][name]["config"]["vocab_size"],
                                            config["modules"][name]["config"][
                                                "max_position_embeddings"]))
                       for name in p["text_towers"]]
        self.sdxl = p["conditioning"] == "sdxl"

    def encode(self, prompts: Sequence[str]):
        """(context [B, T, D], pooled [B, P] or None) for the UNet."""
        dev = next(self.models["unet"].parameters()).device
        outs = [self.models[name](torch.as_tensor(tok(list(prompts)), device=dev))
                for name, tok in self.towers]
        if not self.sdxl:
            return outs[0]["last"], None
        ctx = torch.cat([o["penultimate"] for o in outs], dim=-1)
        pooled = self.models[self.towers[-1][0]].text_projection(outs[-1]["pooled"])
        return ctx, pooled

    @torch.no_grad()
    def images(self, prompts: Sequence[str], seed: int, indices: Sequence[int],
               steps: int, guidance: float, negative: str = "") -> torch.Tensor:
        unet, vae = self.models["unet"], self.models["vae"]
        dev = next(unet.parameters()).device
        n = len(prompts)
        ctx, pooled = self.encode(list(prompts))
        nctx, npooled = self.encode([negative] * n)
        context = torch.cat([nctx, ctx])
        added = {}
        if self.sdxl:
            s = float(self.size)
            ids = torch.tensor([[s, s, 0.0, 0.0, s, s]], device=dev).repeat(2 * n, 1)
            added = {"pooled": torch.cat([npooled, pooled]), "time_ids": ids}
        lat = self.size // 8
        ch = unet.conv_in.in_channels
        x = torch.stack([initial_latents(seed, i, ch, lat, lat) for i in indices]).to(dev)

        def eps_fn(x, t):
            out = unet(torch.cat([x, x]), torch.full((2 * n,), t, device=dev), context, **added)
            e_u, e_t = out.chunk(2)
            return e_u + guidance * (e_t - e_u)

        x = DPMSolverPP2M(self.config["pipeline"]["scheduler"], steps).run(x, eps_fn)
        img = vae(x)
        return (img / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
