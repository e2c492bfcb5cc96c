"""The plain reference of a LoRA fine-tuning step on the SD-1.5 UNet: the
forward process at the batch's timesteps, the UNet with each adapted
weight W + (alpha / r) (a @ b)^T (alpha = r), the epsilon loss weighted by
min-SNR-gamma (Hang et al. 2023: min(SNR, gamma) / SNR), the gradient of
the adapters, the clip by global norm, AdamW (optax's order: Adam with
bias correction, decoupled decay, then the learning rate of a linear
warm-up from 0) and the EMA of the adapters.

It runs in float32 with TF32 off, one batch row at a time (the loss is a
mean over rows, so the rows' gradients add), and imports nothing of the
port.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

# The adapted weights: every attention projection of the UNet's
# transformers (diffusers' LoRA default for the UNet).
TARGETS = re.compile(r".*\.(to_q|to_k|to_v|to_out\.0)\.weight$")


def target_names(unet: torch.nn.Module) -> List[str]:
    """The adapted modules' names, sorted."""
    return sorted(n[: -len(".weight")] for n, p in unet.named_parameters()
                  if TARGETS.match(n) and p.dim() == 2)


def alphas_cumprod(sched: Dict) -> torch.Tensor:
    T = int(sched["num_train_timesteps"])
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, T,
                        dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


class LoRAStep:
    """``step(adapters, batch)`` takes one optimization step of the
    ``adapters`` ({module: {"a": [in, r], "b": [r, out]}}, fp32) on a
    batch {"latents" [B, C, h, w], "context" [B, T, D], "noise" like the
    latents, "timesteps" [B] int} and returns its loss and the gradient
    the optimizer got (after the clip); ``opt`` and ``ema`` hold the
    optimizer's and the EMA's state."""

    def __init__(self, unet: torch.nn.Module, sched: Dict, train: Dict):
        self.unet, self.train = unet, train
        dev = next(unet.parameters()).device
        self.acp = alphas_cumprod(sched).to(dev)
        self.base = dict(unet.named_parameters())
        self.count = 0
        self.mu: Optional[Dict[str, torch.Tensor]] = None
        self.nu: Optional[Dict[str, torch.Tensor]] = None
        self.ema: Optional[Dict[str, torch.Tensor]] = None

    def merged(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name in {k.rsplit("/", 1)[0] for k in flat}:
            a, b = flat[f"{name}/a"], flat[f"{name}/b"]
            out[f"{name}.weight"] = self.base[f"{name}.weight"] + (a @ b).t()
        return out

    def loss_and_grad(self, flat: Dict[str, torch.Tensor], batch: Dict):
        B = batch["latents"].shape[0]
        gamma = self.train.get("snr_gamma")
        total = 0.0
        grads = {k: torch.zeros_like(v) for k, v in flat.items()}
        for i in range(B):  # one row at a time: the loss is a mean over rows
            t = batch["timesteps"][i:i + 1]
            a = self.acp[t][:, None, None, None]
            x0, eps = batch["latents"][i:i + 1], batch["noise"][i:i + 1]
            noisy = a.sqrt() * x0 + (1.0 - a).sqrt() * eps
            leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
            pred = functional_call(self.unet, self.merged(leaves),
                                   (noisy, t.float(), batch["context"][i:i + 1]), strict=False)
            snr = a.flatten() / (1.0 - a.flatten())
            w = torch.clamp(snr, max=gamma) / snr if gamma is not None else torch.ones_like(snr)
            loss = (w * ((pred - eps) ** 2).mean(dim=(1, 2, 3))).sum() / B
            for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                        allow_unused=True)):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        return total, grads

    def step(self, flat: Dict[str, torch.Tensor], batch: Dict):
        """One step on ``flat`` ({"<module>/a" | "/b": fp32}), in place."""
        loss, grads = self.loss_and_grad(flat, batch)
        with torch.no_grad():
            grads = self.update(flat, grads)
        return loss, grads

    def update(self, flat: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """The clip, AdamW and the EMA on ``flat`` in place; returns the
        clipped gradient."""
        tr = self.train
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if float(norm) >= tr["max_grad_norm"]:
            grads = {k: g / norm * tr["max_grad_norm"] for k, g in grads.items()}
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in flat.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in flat.items()}
            self.ema = {k: v.clone() for k, v in flat.items()}
        self.count += 1
        b1, b2 = tr["betas"]
        lr = tr["learning_rate"] * min(1.0, (self.count - 1) / tr["warmup_steps"]) \
            if tr["warmup_steps"] else tr["learning_rate"]
        for k, p in flat.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_((1 - b1) * g)
            self.nu[k].mul_(b2).add_((1 - b2) * g * g)
            m_hat = self.mu[k] / (1 - b1 ** self.count)
            v_hat = self.nu[k] / (1 - b2 ** self.count)
            u = m_hat / (v_hat.sqrt() + tr["eps"]) + tr["weight_decay"] * p
            p.add_(-lr * u)
            self.ema[k].mul_(tr["ema_decay"]).add_((1 - tr["ema_decay"]) * p)
        return grads
