"""Serving: the micro-batching ``InferenceServer`` (``serving/batcher.py``)
that coalesces concurrent requests into full batches, and its HTTP front
end (``serving/server.py``).  Counterpart of
``sonicdiffusionbayeslab_tpu/serving``."""

from sonicdiffusionbayeslab_torch.serving.batcher import (
    GenerateRequest,
    InferenceServer,
    ServerOverloadedError,
)

__all__ = ["GenerateRequest", "InferenceServer", "ServerOverloadedError"]
