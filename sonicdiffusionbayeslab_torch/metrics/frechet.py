"""Fréchet distance between Gaussians fitted to feature sets (FID's math).

The port's copy of ``sonicdiffusionbayeslab_tpu/metrics/frechet.py``:
streaming first and second moments in float64, and
|mu1 - mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}) with an eigenvalue-based
matrix square root (stable on near-singular products, where scipy's sqrtm
is not).
"""

from __future__ import annotations

import numpy as np


class StreamingMoments:
    """Accumulates the mean and covariance of feature rows in float64."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {feats.shape}")
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def mean_cov(self):
        if self.n < 2:
            raise ValueError("need >= 2 samples for covariance")
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov

    def reset(self) -> None:
        self.n = 0
        self.sum[:] = 0
        self.outer[:] = 0


def _sqrtm_product(c1: np.ndarray, c2: np.ndarray) -> float:
    """tr((C1 C2)^{1/2}) through the symmetric form: (C1 C2)^{1/2} has the
    trace of (S1 C2 S1)^{1/2}, S1 = C1^{1/2}."""
    vals1, vecs1 = np.linalg.eigh(c1)
    vals1 = np.clip(vals1, 0, None)
    s1 = (vecs1 * np.sqrt(vals1)) @ vecs1.T
    m = s1 @ c2 @ s1
    vals = np.linalg.eigvalsh(m)
    return float(np.sum(np.sqrt(np.clip(vals, 0, None))))


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    diff = mu1 - mu2
    tr_sqrt = _sqrtm_product(np.asarray(cov1, np.float64), np.asarray(cov2, np.float64))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)
