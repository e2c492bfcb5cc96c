"""Metrics of the port: ``time_metric`` and ``clip_score``.

Counterparts of ``Metric``, ``TimeMetric``, ``_ClipBackend`` and
``ClipScoreMetric`` in ``sonicdiffusionbayeslab_tpu/metrics/metrics.py``,
with the same update()/compute()/reset() protocol.  ``compute`` sums this
process's statistics (one process; the cross-process sums are not ported).

The CLIP score runs a CLIP ViT-B/16 dual encoder (``tiny``: the tiny
geometry) in fp32 on the metric's device.  Its weights come from a local
transformers ``CLIPModel`` snapshot when ``model_name_or_path`` is a
directory holding one, else from a seeded random init, with a warning:
scores of a random tower are not comparable to anyone's.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.registry import metrics_registry


class Metric:
    """update()/compute()/reset() protocol (torchmetrics-style)."""

    def update(self, *a, **k):  # pragma: no cover - interface
        raise NotImplementedError

    def compute(self):  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self):  # pragma: no cover - interface
        raise NotImplementedError


@metrics_registry.add_to_registry("time_metric")
class TimeMetric(Metric):
    """sec/image = sum(denoise-loop seconds) / sum(batch sizes)."""

    def __init__(self):
        self.reset()

    def update(self, inference_time: float, batch_size: int) -> None:
        self.time_sum += float(inference_time)
        self.images += int(batch_size)

    def compute(self) -> float:
        return self.time_sum / max(self.images, 1)

    def reset(self) -> None:
        self.time_sum = 0.0
        self.images = 0


class _ClipBackend:
    """The CLIP dual encoder, its tokenizer and the scoring call on one
    device (shared through :func:`_clip_backend`)."""

    def __init__(self, model_name_or_path: Optional[str] = None, tiny: bool = False,
                 device=None):
        from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
        from sonicdiffusionbayeslab_torch.models.clip_vision import (
            CLIP_B16_TEXT,
            CLIPDualEncoder,
            CLIPVisionConfig,
        )
        from sonicdiffusionbayeslab_torch.models.sampler import init_module
        from sonicdiffusionbayeslab_torch.models.tokenizer import load_tokenizer
        from sonicdiffusionbayeslab_torch.utils.device import resolve_device

        if tiny:
            vcfg, tcfg, proj = CLIPVisionConfig.tiny(), CLIPTextConfig.tiny(), 16
        else:
            vcfg, tcfg, proj = CLIPVisionConfig(), CLIP_B16_TEXT, 512
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = CLIPDualEncoder(vcfg, tcfg, projection_dim=proj)
        self.model.requires_grad_(False).eval()
        self.tokenizer = load_tokenizer(model_name_or_path, tcfg.vocab_size, tcfg.max_length)
        if not self._try_load(model_name_or_path):
            gen = torch.Generator(device=self.device).manual_seed(0)
            init_module(self.model, gen)
            with torch.no_grad():
                self.model.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
            logging.getLogger(__name__).warning(
                "clip_score: no local CLIP checkpoint at %r; scoring with a RANDOM-init tower "
                "(scores are not comparable to real CLIP scores)", model_name_or_path)

    def _try_load(self, path: Optional[str]) -> bool:
        """Load a local snapshot if ``path`` exists; False when it does not
        (a hub id with no local copy)."""
        from sonicdiffusionbayeslab_torch.models.weights import load_clip_checkpoint

        if not path or not Path(path).exists():
            return False
        load_clip_checkpoint(path, self.model)
        return True

    @torch.inference_mode()
    def scores(self, images: np.ndarray, prompts: Sequence[str]) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> CLIP scores [N]."""
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts))), dtype=torch.long,
                              device=self.device)
        px = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return self.model(px, ids).cpu().numpy()


@functools.lru_cache(maxsize=4)
def _clip_backend(model_name_or_path: Optional[str], tiny: bool, device) -> _ClipBackend:
    return _ClipBackend(model_name_or_path, tiny, device)


@metrics_registry.add_to_registry("clip_score")
class ClipScoreMetric(Metric):
    """Mean CLIP score over (image, prompt) pairs.  ``device`` is the
    port's addition (CUDA unless given)."""

    def __init__(self, model_name_or_path: str = "openai/clip-vit-base-patch16",
                 tiny: bool = False, device=None):
        self.backend = _clip_backend(model_name_or_path, bool(tiny),
                                     None if device is None else str(device))
        self.reset()

    def update(self, images: np.ndarray, prompts: Sequence[str]) -> None:
        """images: [N, H, W, 3] float in [0, 1]."""
        s = self.backend.scores(images, prompts)
        self.score_sum += float(s.sum())
        self.n += len(s)

    def calc_metric(self, images, prompts) -> float:
        self.update(images, prompts)
        return self.compute()

    def compute(self) -> float:
        return self.score_sum / max(self.n, 1)

    def reset(self) -> None:
        self.score_sum = 0.0
        self.n = 0
