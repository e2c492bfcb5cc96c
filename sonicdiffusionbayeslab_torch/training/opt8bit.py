"""Blockwise 8-bit AdamW: Adam with both moments stored as dynamic-int8
codes and per-block fp32 scales.

The port's copy of ``sonicdiffusionbayeslab_tpu/training/opt8bit.py``
(Dettmers et al. 2022, the paper's dynamic data type, blocks of 2048
elements), in torch ops: the same code tables (``_dynamic_code``, built in
numpy as there), the same nearest-code quantization (a binary search of
the sorted table, then the nearer neighbour) and the same update.  The
first moment is stored as m / absmax(block), the second as
sqrt(v) / absmax(block).  Leaves are updated one at a time, so the fp32
moments exist for one leaf at once (the JAX package orders them with an
optimization barrier for the same reason).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.training.optim import (
    Transform,
    _f32,
    add_decayed_weights,
    chain,
    scale_by_learning_rate,
)

BLOCK = 2048  # elements per quantization block


@functools.lru_cache(maxsize=None)
def _dynamic_code(signed: bool) -> np.ndarray:
    """The 8-bit dynamic data type: 256 sorted values in [-1, 1] (signed)
    or [0, 1] (unsigned): log-spaced decades, linear inside each."""
    values = {0.0}
    n_dec = 7
    frac_bits_total = 7 if signed else 8  # sign consumes one bit
    for dec in range(n_dec):
        # decade dec covers (10^-(dec+1), 10^-dec]
        n_frac = 2 ** (frac_bits_total - 1 - dec) if dec < frac_bits_total else 1
        n_frac = max(int(n_frac), 1)
        lo, hi = 10.0 ** -(dec + 1), 10.0 ** -dec
        for i in range(1, n_frac + 1):
            values.add(lo + (hi - lo) * i / n_frac)
    vals = np.array(sorted(values), np.float32)
    if signed:
        vals = np.unique(np.concatenate([-vals, vals]))
    # pad/trim to exactly 256 by inserting midpoints in the largest gaps
    while len(vals) < 256:
        gaps = np.diff(vals)
        i = int(np.argmax(gaps))
        vals = np.insert(vals, i + 1, (vals[i] + vals[i + 1]) / 2)
    if len(vals) > 256:
        keep = np.linspace(0, len(vals) - 1, 256).round().astype(int)
        vals = vals[keep]
    return vals.astype(np.float32)


def code_table(signed: bool, device=None) -> torch.Tensor:
    return torch.from_numpy(_dynamic_code(signed)).to(device)


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def quantize(x: torch.Tensor, signed: bool):
    """x (any shape) -> (codes uint8 [blocks, BLOCK], scales fp32 [blocks]):
    each block over its absmax, then the nearest entry of the code table."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    blocks = torch.nn.functional.pad(flat, (0, _pad_len(n) - n)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    norm = blocks / torch.where(scale > 0, scale, torch.ones_like(scale))
    code = code_table(signed, x.device)
    idx = torch.searchsorted(code, norm).clamp_(0, 255)
    below = (idx - 1).clamp_(0, 255)
    idx = torch.where((norm - code[below]).abs() <= (code[idx] - norm).abs(), below, idx)
    return idx.to(torch.uint8), scale[:, 0]


def dequantize(codes: torch.Tensor, scales: torch.Tensor, signed: bool, shape) -> torch.Tensor:
    vals = code_table(signed, codes.device)[codes.long()] * scales[:, None]
    n = int(np.prod(shape))
    return vals.reshape(-1)[:n].reshape(shape)


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """Adam with both moments stored as blockwise dynamic-int8."""
    def init(params):
        leaves = {}
        for k, p in params.items():
            nb = _pad_len(p.numel()) // BLOCK
            leaves[k] = {"m_codes": torch.zeros((nb, BLOCK), dtype=torch.uint8, device=p.device),
                         "m_scale": torch.zeros(nb, dtype=torch.float32, device=p.device),
                         "r_codes": torch.zeros((nb, BLOCK), dtype=torch.uint8, device=p.device),
                         "r_scale": torch.zeros(nb, dtype=torch.float32, device=p.device)}
        return {"count": 0, "leaves": leaves}

    def update(updates, state, params):
        count = state["count"] + 1
        bc1, bc2 = _f32(1.0 - _f32(b1) ** count), _f32(1.0 - _f32(b2) ** count)
        out = {}
        for k, g in updates.items():
            leaf = state["leaves"][k]
            m = dequantize(leaf["m_codes"], leaf["m_scale"], True, g.shape)
            r = dequantize(leaf["r_codes"], leaf["r_scale"], False, g.shape)
            g = g.float()
            m = b1 * m + (1.0 - b1) * g
            v = b2 * (r * r) + (1.0 - b2) * g * g
            out[k] = (m / bc1) / ((v / bc2).sqrt() + eps)
            leaf["m_codes"], leaf["m_scale"] = quantize(m, True)
            leaf["r_codes"], leaf["r_scale"] = quantize(v.sqrt(), False)
        return out, {**state, "count": count}

    return Transform(init, update)


def adamw8bit(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0) -> Transform:
    """AdamW with 8-bit moments: ``scale_by_adam8bit``, decoupled weight
    decay, ``* -lr``, as optax.adamw composes them."""
    txs = [scale_by_adam8bit(b1, b2, eps)]
    if weight_decay:
        txs.append(add_decayed_weights(weight_decay))
    txs.append(scale_by_learning_rate(learning_rate))
    return chain(*txs)
