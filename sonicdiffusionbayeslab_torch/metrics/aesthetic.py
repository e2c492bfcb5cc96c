"""The LAION aesthetic predictor head: a linear 768->1024->128->64->16->1
stack (dropout between, no activations) over L2-normalised CLIP ViT-L/14
image embeddings.

Counterpart of ``sonicdiffusionbayeslab_tpu/metrics/aesthetic.py``.  The
module's names are the reference checkpoint's (``layers.{0,2,4,6,7}``,
``data/models/aethetic_score_model.pth``), so it loads by name.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


class AestheticScoreMLP(nn.Module):
    def __init__(self, input_size: int = 768):
        super().__init__()
        self.input_size = input_size
        self.layers = nn.Sequential(nn.Linear(input_size, 1024), nn.Dropout(0.2),
                                    nn.Linear(1024, 128), nn.Dropout(0.2),
                                    nn.Linear(128, 64), nn.Dropout(0.1),
                                    nn.Linear(64, 16), nn.Linear(16, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


def normalized(a: np.ndarray, axis: int = -1, order: int = 2) -> np.ndarray:
    """L2-normalise embeddings in float64, returned as float32."""
    a = np.asarray(a, np.float64)
    n = np.linalg.norm(a, ord=order, axis=axis, keepdims=True)
    return (a / np.clip(n, 1e-12, None)).astype(np.float32)


def load_torch_checkpoint(path: str | Path) -> Dict[str, torch.Tensor]:
    """The reference-format torch or Lightning checkpoint (``layers.{0,2,4,6,7}``,
    optionally under ``state_dict``) -> the module's state dict, fp32."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {f"layers.{i}.{p}": sd[f"layers.{i}.{p}"].float()
            for i in (0, 2, 4, 6, 7) for p in ("weight", "bias")}


class AestheticScorer:
    """CLIP image embeddings [B, input_size] (numpy) -> aesthetic scores [B]
    (numpy).  Random-init (seeded) unless given a checkpoint."""

    def __init__(self, checkpoint: Optional[str] = None, input_size: int = 768, device=None):
        from sonicdiffusionbayeslab_torch.models.sampler import init_module
        from sonicdiffusionbayeslab_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = AestheticScoreMLP(input_size)
        self.model.requires_grad_(False).eval()
        if checkpoint:
            self.model.load_state_dict(load_torch_checkpoint(checkpoint), strict=True)
        else:
            init_module(self.model, torch.Generator(device=self.device).manual_seed(0))

    @torch.inference_mode()
    def __call__(self, embeddings: np.ndarray) -> np.ndarray:
        from sonicdiffusionbayeslab_torch.utils.device import full_fp32

        with full_fp32():
            x = torch.as_tensor(normalized(embeddings), device=self.device)
            return self.model(x)[:, 0].cpu().numpy()
