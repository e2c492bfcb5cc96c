"""Metrics of the port (registered in ``metrics_registry`` on import):
``time_metric``, ``clip_score``, ``image_reward``, ``aesthetic_score`` and
``fid``."""

from sonicdiffusionbayeslab_torch.metrics.frechet import frechet_distance  # noqa: F401
from sonicdiffusionbayeslab_torch.metrics.metrics import (  # noqa: F401
    FID,
    AestheticScoreMetric,
    ClipScoreMetric,
    Metric,
    RewardModel,
    TimeMetric,
)
