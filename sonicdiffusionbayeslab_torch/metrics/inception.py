"""FID-Inception (InceptionV3) feature taps for FID, in PyTorch (NCHW).

Counterpart of ``sonicdiffusionbayeslab_tpu/metrics/inception.py``:
pytorch-fid's FID-Inception, the torchvision InceptionV3 geometry with its
pool branches patched (average pools leave padding out of the count;
Mixed_7c's pool branch is a max pool), and feature taps by global mean
after each block group: 64 (stem), 192 (Conv 3b/4a), 768 (Mixed_5b..6e),
2048 (Mixed_7a..7c).  BatchNorm is frozen (eval-mode statistics, eps
1e-3), then ReLU.  Module and buffer names are pytorch-fid's
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch5x5_1.bn.running_mean``,
...), so its state dict loads by name (``load_inception_weights``).

Input: images [B, H, W, 3] in [0, 1] are resized to 299x299 with an
antialiased bilinear filter (``jax.image.resize``'s "bilinear"), then
scaled to [-1, 1].  The reference computes all of this in plain XLA, so
stock convolutions and pools stand; on the card they run in fp32 with
TF32 off (``utils/device.py::full_fp32``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Pad = Union[int, Tuple[int, int]]

TAPS = (64, 192, 768, 2048)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics: (x - mean) / sqrt(var + eps) * w + b."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = lambda v: v[:, None, None]  # noqa: E731
        return ((x - c(self.running_mean)) * torch.rsqrt(c(self.running_var) + self.eps)
                * c(self.weight) + c(self.bias))


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm + ReLU (torchvision's BasicConv2d in
    eval mode)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3s1p1(x):
    # FID-Inception's pool branches: count_include_pad=False.
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    """``pool``: "avg" (Mixed_7b, padding out of the count) or "max" (Mixed_7c)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avgpool3s1p1(x)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], 1)


class InceptionBlocks(nn.Module):
    """FID-Inception through the requested deepest tap (64/192/768/2048);
    images [B, 3, H, W] in [-1, 1] -> {tap: [B, tap]}."""

    def __init__(self, max_tap: int = 2048):
        super().__init__()
        if max_tap not in TAPS:
            raise ValueError(f"max_tap must be one of {TAPS}, got {max_tap}")
        self.max_tap = max_tap
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        if max_tap >= 192:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        if max_tap >= 768:
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
        if max_tap == 2048:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        taps: Dict[int, torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        taps[64] = x.mean((2, 3))
        if self.max_tap == 64:
            return taps
        x = _maxpool3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        taps[192] = x.mean((2, 3))
        if self.max_tap == 192:
            return taps
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        taps[768] = x.mean((2, 3))
        if self.max_tap == 768:
            return taps
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        taps[2048] = x.mean((2, 3))
        return taps


def inception_input(images: torch.Tensor) -> torch.Tensor:
    """Images [B, H, W, 3] in [0, 1] -> [B, 3, 299, 299] in [-1, 1]: the
    antialiased bilinear resize first, then the scale."""
    x = images.permute(0, 3, 1, 2)
    if x.shape[-2:] != (299, 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", antialias=True,
                          align_corners=False)
    return x * 2.0 - 1.0


def load_inception_weights(path: str | Path, model: InceptionBlocks) -> InceptionBlocks:
    """A pytorch-fid (or torchvision) InceptionV3 state dict into ``model``.
    The file's blocks past ``model.max_tap``, its ``fc`` and ``AuxLogits``
    heads and BatchNorm's ``num_batches_tracked`` counters are dropped by
    name; any other extra or missing key raises."""
    from sonicdiffusionbayeslab_torch.models.weights import _load_strict, load_torch_state_dict

    sd = load_torch_state_dict(path)
    kept = {k.split(".")[0] for k in model.state_dict()}
    def drop(k):
        top = k.split(".")[0]
        return (k.endswith(".num_batches_tracked") or top in ("fc", "AuxLogits")
                or (top not in kept and top.startswith(("Conv2d_", "Mixed_"))))

    _load_strict(model, sd, drop, str(path))
    return model


class InceptionFeatures:
    """Callable: images [B, H, W, 3] in [0, 1] (numpy) -> [B, feature]
    float32 numpy.  Random-init (seeded) unless given a checkpoint."""

    def __init__(self, feature: int = 64, checkpoint: Optional[str] = None, device=None):
        from sonicdiffusionbayeslab_torch.models.sampler import init_module
        from sonicdiffusionbayeslab_torch.utils.device import resolve_device

        if feature not in TAPS:
            raise ValueError(f"InceptionFeatures supports taps {TAPS}")
        self.feature = feature
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = InceptionBlocks(max_tap=feature)
        self.model.requires_grad_(False).eval()
        if checkpoint:
            load_inception_weights(checkpoint, self.model)
        else:
            init_module(self.model, torch.Generator(device=self.device).manual_seed(0))

    @torch.inference_mode()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] on the device -> [B, feature]."""
        return self.model(inception_input(images))[self.feature]

    def __call__(self, images: np.ndarray) -> np.ndarray:
        from sonicdiffusionbayeslab_torch.utils.device import full_fp32

        with full_fp32():
            x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
            return self.features(x).cpu().numpy()
