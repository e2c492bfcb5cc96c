"""Metrics of the port: ``time_metric``, ``clip_score``, ``image_reward``,
``aesthetic_score`` and ``fid``.

Counterparts of ``Metric``, ``TimeMetric``, ``_ClipBackend``,
``ClipScoreMetric``, ``RewardModel``, ``AestheticScoreMetric`` and ``FID``
in ``sonicdiffusionbayeslab_tpu/metrics/metrics.py``, with the same
update()/compute()/reset() protocol, registry names and arguments (plus
``device``: CUDA unless given).  ``compute`` sums each metric's
statistics across the ranks of a multi-process run
(``parallel/distributed.py``; the identity in one process), so a rank
updates with its own rows and every rank computes the global value.

Every tower runs in fp32 on the metric's device, with TF32 off for its
matmuls and convolutions (``utils/device.py::full_fp32``): the CLIP dual
encoders (ViT-B/16 for the CLIP score and FID's non-tap features, ViT-L/14
for the aesthetic score, ``tiny`` for both), FID-Inception, ImageReward's
BLIP.  Weights come from local files where given (a transformers
``CLIPModel`` snapshot directory, pytorch-fid's Inception state dict,
``ImageReward.pt``, the LAION head), else from a seeded random init, with
a warning: scores of a random tower are not comparable to anyone's.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.metrics.frechet import StreamingMoments, frechet_distance
from sonicdiffusionbayeslab_torch.parallel.distributed import all_sum_array, all_sum_scalar
from sonicdiffusionbayeslab_torch.registry import metrics_registry
from sonicdiffusionbayeslab_torch.utils.device import full_fp32

_log = logging.getLogger(__name__)


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
        t = all_sum_scalar(self.time_sum)
        n = all_sum_scalar(self.images)
        return t / max(n, 1)

    def reset(self) -> None:
        self.time_sum = 0.0
        self.images = 0


class _ClipBackend:
    """A CLIP dual encoder, its tokenizer and the scoring calls on one device
    (shared through :func:`_clip_backend`).  ``geometry``: "b16" (ViT-B/16
    with its own text tower, projection 512) or "l14" (ViT-L/14 with
    SD-1.5's text tower, projection 768); ``tiny`` overrides it."""

    def __init__(self, model_name_or_path: Optional[str] = None, tiny: bool = False,
                 device=None, geometry: str = "b16"):
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
        elif geometry == "l14":
            vcfg, tcfg, proj = CLIPVisionConfig.vit_l14(), CLIPTextConfig.sd15(), 768
        elif geometry == "b16":
            vcfg, tcfg, proj = CLIPVisionConfig(), CLIP_B16_TEXT, 512
        else:
            raise ValueError(f"unknown CLIP geometry {geometry!r}: 'b16' or 'l14'")
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
            _log.warning("CLIP (%s): no local CLIP checkpoint at %r; scoring with a RANDOM-init "
                         "tower (scores are not comparable to real CLIP scores)",
                         "tiny" if tiny else geometry, model_name_or_path)

    def _try_load(self, path: Optional[str]) -> bool:
        """Load a local snapshot if ``path`` exists; False when it does not
        (a hub id with no local copy)."""
        from sonicdiffusionbayeslab_torch.models.weights import load_clip_checkpoint

        if not path or not Path(path).exists():
            return False
        load_clip_checkpoint(path, self.model)
        return True

    def _images(self, images: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images, np.float32), device=self.device)

    @torch.inference_mode()
    def scores(self, images: np.ndarray, prompts: Sequence[str]) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> CLIP scores [N]."""
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts))), dtype=torch.long,
                              device=self.device)
        with full_fp32():
            return self.model(self._images(images), ids).cpu().numpy()

    @torch.inference_mode()
    def image_features(self, images: np.ndarray) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> L2-normalised projected image
        embeddings [N, P]."""
        with full_fp32():
            return self.model.embed_image(self._images(images)).cpu().numpy()


@functools.lru_cache(maxsize=4)
def _clip_backend_cached(model_name_or_path, tiny, device, geometry) -> _ClipBackend:
    return _ClipBackend(model_name_or_path, tiny, device, geometry)


def _clip_backend(model_name_or_path: Optional[str], tiny: bool, device,
                  geometry: str = "b16") -> _ClipBackend:
    """The cached backend of (checkpoint, tiny, device, geometry); tiny
    ignores the geometry, so a tiny run's metrics share one tower."""
    return _clip_backend_cached(model_name_or_path, bool(tiny),
                                None if device is None else str(device),
                                "b16" if tiny else geometry)


@metrics_registry.add_to_registry("clip_score")
class ClipScoreMetric(Metric):
    """Mean CLIP score over (image, prompt) pairs."""

    def __init__(self, model_name_or_path: str = "openai/clip-vit-base-patch16",
                 tiny: bool = False, device=None):
        self.backend = _clip_backend(model_name_or_path, tiny, device)
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
        s = all_sum_scalar(self.score_sum)
        n = all_sum_scalar(self.n)
        return s / max(n, 1)

    def reset(self) -> None:
        self.score_sum = 0.0
        self.n = 0


DEFAULT_IMAGE_REWARD = "data/models/ImageReward.pt"


@metrics_registry.add_to_registry("image_reward")
class RewardModel(Metric):
    """Win rate of generated over real images under a reward scorer: for
    each (prompt, real, generated) triple both images are scored, a win is
    s_gen >= s_real, and ``compute`` is the mean.

    The scorer is ImageReward-v1.0 (BLIP) whenever a checkpoint is found:
    ``checkpoint=``, else ``data/models/ImageReward.pt`` under the working
    directory (the port reads no environment variable, so the JAX
    package's ``SDBL_IMAGE_REWARD_CKPT`` is not consulted).  ``tiny`` with
    a checkpoint loads a tiny BLIP.  Without one the metric falls back to
    CLIP text-image similarity, and warns unless ``tiny``: win rates under
    the fallback are not comparable to the reference's.
    """

    def __init__(
        self,
        model_name: str = "ImageReward-v1.0",
        scorer: Optional[Callable[[np.ndarray, Sequence[str]], np.ndarray]] = None,
        checkpoint: Optional[str] = None,
        vocab_path: Optional[str] = None,
        tiny: bool = False,
        device=None,
    ):
        self.model_name = model_name
        if scorer is None:
            if checkpoint is None and not tiny and Path(DEFAULT_IMAGE_REWARD).exists():
                checkpoint = DEFAULT_IMAGE_REWARD
            if checkpoint is not None:
                from sonicdiffusionbayeslab_torch.metrics.image_reward_model import (
                    ImageRewardScorer,
                )

                scorer = ImageRewardScorer(checkpoint, tiny=tiny, vocab_path=vocab_path,
                                           device=device)
            else:
                if not tiny:
                    _log.warning(
                        "image_reward: no ImageReward checkpoint found (checkpoint= or %s) - "
                        "falling back to CLIP text-image similarity. Win rates are NOT "
                        "comparable to the reference's BLIP-based ImageReward-v1.0.",
                        DEFAULT_IMAGE_REWARD)
                scorer = _clip_backend(None, tiny, device).scores
        self._scorer = scorer
        self.reset()

    def update(self, prompts: Sequence[str], real: np.ndarray, gen: np.ndarray) -> None:
        s_real = self._scorer(real, prompts)
        s_gen = self._scorer(gen, prompts)
        self.wins += int(np.sum(s_gen >= s_real))
        self.n += len(prompts)

    def compute(self) -> float:
        wins = all_sum_scalar(self.wins)
        n = all_sum_scalar(self.n)
        return wins / max(n, 1)

    def reset(self) -> None:
        self.wins = 0
        self.n = 0


@metrics_registry.add_to_registry("aesthetic_score")
class AestheticScoreMetric(Metric):
    """Mean LAION aesthetic score of the generated images: CLIP ViT-L/14
    image embeddings -> L2-normalised -> the predictor's MLP -> mean.  The
    head is ``checkpoint`` (the reference's in-repo
    ``data/models/aethetic_score_model.pth``, relative to the working
    directory) unless ``tiny``; a missing file warns and falls back to a
    random head."""

    def __init__(
        self,
        checkpoint: str = "data/models/aethetic_score_model.pth",
        clip_model_name_or_path: Optional[str] = None,
        tiny: bool = False,
        device=None,
    ):
        from sonicdiffusionbayeslab_torch.metrics.aesthetic import AestheticScorer

        self.backend = _clip_backend(clip_model_name_or_path, tiny, device, "l14")
        ckpt = checkpoint if (checkpoint and Path(checkpoint).exists() and not tiny) else None
        if checkpoint and ckpt is None and not tiny:
            _log.warning("aesthetic_score: checkpoint %s not found - RANDOM-INIT MLP (scores "
                         "are not comparable to the LAION predictor)", checkpoint)
        self.scorer = AestheticScorer(ckpt, input_size=16 if tiny else 768,
                                      device=self.backend.device)
        self.reset()

    def update(self, images: np.ndarray, prompts: Sequence[str] = ()) -> None:
        """images: [N, H, W, 3] float in [0, 1] (prompts unused)."""
        s = self.scorer(self.backend.image_features(images))
        self.score_sum += float(s.sum())
        self.n += len(s)

    def compute(self) -> float:
        s = all_sum_scalar(self.score_sum)
        n = all_sum_scalar(self.n)
        return s / max(n, 1)

    def reset(self) -> None:
        self.score_sum = 0.0
        self.n = 0


@metrics_registry.add_to_registry("fid")
class FID(Metric):
    """Fréchet distance between the real and generated images' feature
    Gaussians (two streaming moment accumulators, ``metrics/frechet.py``).
    Features: FID-Inception at the taps 64/192/768/2048
    (``metrics/inception.py``; pytorch-fid weights through
    ``inception_checkpoint``); with ``tiny`` or another ``feature`` count,
    CLIP image embeddings times a fixed random projection
    (``np.random.default_rng(0)``, so runs stay comparable)."""

    def __init__(
        self,
        feature: int = 64,
        input_img_size: int = 512,
        normalize: bool = False,
        tiny: bool = False,
        inception_checkpoint: Optional[str] = None,
        device=None,
    ):
        from sonicdiffusionbayeslab_torch.metrics.inception import TAPS, InceptionFeatures

        self.feature = int(feature)
        self.input_img_size = input_img_size
        self.normalize = normalize
        self._inception = None
        self._proj: Optional[np.ndarray] = None
        if not tiny and self.feature in TAPS:
            self._inception = InceptionFeatures(self.feature, inception_checkpoint, device)
        else:
            self.backend = _clip_backend(None, tiny, device)
        self.real = StreamingMoments(self.feature)
        self.fake = StreamingMoments(self.feature)

    def _features(self, images: np.ndarray) -> np.ndarray:
        if self._inception is not None:
            return self._inception(images)
        f = self.backend.image_features(images)
        if f.shape[1] != self.feature:
            if self._proj is None or self._proj.shape != (f.shape[1], self.feature):
                rng = np.random.default_rng(0)
                self._proj = rng.standard_normal((f.shape[1], self.feature)) / np.sqrt(f.shape[1])
            f = f @ self._proj
        return f

    def update(self, images: np.ndarray, real: bool) -> None:
        (self.real if real else self.fake).update(self._features(images))

    @staticmethod
    def _global_mean_cov(m: StreamingMoments):
        """mean_cov over the moments summed across the ranks."""
        n = int(all_sum_scalar(m.n))
        if n < 2:
            raise ValueError("need >= 2 samples for covariance")
        s = all_sum_array(m.sum)
        outer = all_sum_array(m.outer)
        mu = s / n
        cov = (outer - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov

    def compute(self) -> float:
        mu1, c1 = self._global_mean_cov(self.real)
        mu2, c2 = self._global_mean_cov(self.fake)
        return frechet_distance(mu1, c1, mu2, c2)

    def reset(self) -> None:
        self.real.reset()
        self.fake.reset()
