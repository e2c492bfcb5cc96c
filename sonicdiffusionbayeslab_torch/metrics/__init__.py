"""Metrics of the port (registered in ``metrics_registry`` on import):
``time_metric`` and ``clip_score``.  ``fid``, ``image_reward`` and
``aesthetic_score`` are not ported yet."""

from sonicdiffusionbayeslab_torch.metrics.metrics import (  # noqa: F401
    ClipScoreMetric,
    Metric,
    TimeMetric,
)
