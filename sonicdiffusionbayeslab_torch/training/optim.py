"""The optimizers of the trainer: the port's copies of the optax transforms
that ``sonicdiffusionbayeslab_tpu/training/trainer.py`` chains, with
optax's semantics (no ``torch.optim`` class matches them: its
``clip_grad_norm_`` scales by ``max / (norm + 1e-6)``, its ``Adafactor``
has other defaults).

A transform works on a flat ``{name: tensor}`` tree: ``init(params)`` gives
its state, ``update(updates, state, params)`` the new updates and state.
Its state tensors are updated in place, and the updates it receives may be
overwritten (the trainer hands it fresh gradients).  ``apply_updates``
adds the updates to the parameters in place.  Counts and schedules run
on the host, as Python numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class Transform:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def chain(*txs: Transform) -> Transform:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(updates, state, params):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, new

    return Transform(init, update)


def _empty(params):
    return None


def _f32(x: float) -> float:
    """``x`` rounded to float32, as optax computes its scalars."""
    return float(np.float32(x))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: ``init`` at count 0, ``end`` from
    ``transition_steps`` on, linear between (so a warmup's count 0 is 0)."""
    f32 = np.float32

    def schedule(count: int) -> float:  # in fp32, as optax evaluates it
        frac = f32(1) - f32(min(max(count, 0), transition_steps)) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, a 0-dim fp32 tensor."""
    return torch.stack([g.float().square().sum() for g in tree.values()]).sum().sqrt()


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax.clip_by_global_norm: ``t / norm * max_norm`` where the global
    norm is not below ``max_norm``, else unchanged (no epsilon; decided on
    the device, without a host sync)."""
    def update(updates, state, params):
        norm = global_norm(updates)
        keep = norm < max_norm
        return {k: torch.where(keep, t, t / norm.to(t.dtype) * max_norm)
                for k, t in updates.items()}, state

    return Transform(_empty, update)


def _count_state(params):
    return {"count": 0}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """optax.scale_by_adam: bias-corrected ``m / (sqrt(v) + eps)``."""
    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params):
        count = state["count"] + 1
        bc1, bc2 = 1.0 - _f32(b1) ** count, 1.0 - _f32(b2) ** count
        out = {}
        for k, g in updates.items():
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(b1).add_(g * (1.0 - b1))
            nu.mul_(b2).add_(g * g * (1.0 - b2))
            out[k] = (mu / _f32(bc1)) / ((nu / _f32(bc2)).sqrt() + eps)
        return out, {**state, "count": count}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params):
        return {k: u.add_(params[k] * weight_decay) for k, u in updates.items()}, state

    return Transform(_empty, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule],
                           flip_sign: bool = True) -> Transform:
    """Multiply by ``-lr`` (``flip_sign``) or ``lr``; a schedule is read at
    this transform's own count, which starts at 0."""
    m = -1.0 if flip_sign else 1.0

    def update(updates, state, params):
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        step = _f32(m * lr)
        return {k: u.mul_(step) for k, u in updates.items()}, {"count": state["count"] + 1}

    return Transform(_count_state, update)


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """optax.adam: Adam, then ``* -lr``."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    """optax.adamw: Adam, then decoupled decay ``+ wd * p``, then ``* -lr``."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """The two largest axes (optax's ``_factored_dims``; ties by index), or
    None when the second largest is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> Transform:
    """optax.scale_by_factored_rms: the gradient over the root of Adafactor's
    second-moment estimate, factored into row and column means over the
    two largest axes where both are at least ``min_dim_size_to_factor``,
    with decay ``1 - (t + 1)^-decay_rate`` at count t."""
    def init(params):
        stats = {}
        for k, p in params.items():
            dims = _factored_dims(p.shape, min_dim_size_to_factor)
            if dims is None:
                stats[k] = {"v": torch.zeros_like(p)}
            else:
                d1, d0 = dims
                shape = list(p.shape)
                stats[k] = {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                            "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:])}
        return {"count": 0, "stats": stats}

    def update(updates, state, params):
        decay = _f32(1.0 - np.float32(state["count"] + 1) ** np.float32(-decay_rate))
        out = {}
        for k, g in updates.items():
            s = state["stats"][k]
            grad_sqr = g * g + epsilon
            dims = _factored_dims(g.shape, min_dim_size_to_factor)
            if dims is None:
                s["v"].mul_(decay).add_(grad_sqr * (1.0 - decay))
                out[k] = g * s["v"] ** -0.5
                continue
            d1, d0 = dims
            s["v_row"].mul_(decay).add_(grad_sqr.mean(dim=d0) * (1.0 - decay))
            s["v_col"].mul_(decay).add_(grad_sqr.mean(dim=d1) * (1.0 - decay))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (s["v_row"] / s["v_row"].mean(dim=reduced_d1, keepdim=True)) ** -0.5
            out[k] = g * row_factor.unsqueeze(d0) * s["v_col"].unsqueeze(d1) ** -0.5
        return out, {**state, "count": state["count"] + 1}

    return Transform(init, update)


def clip_by_block_rms(threshold: float) -> Transform:
    """optax.clip_by_block_rms: each tensor over max(1, rms / threshold)."""
    def update(updates, state, params):
        return {k: u / torch.clamp(u.square().mean().sqrt() / threshold, min=1.0)
                for k, u in updates.items()}, state

    return Transform(_empty, update)


def scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    """optax.scale_by_param_block_rms: times each parameter's rms, at least
    ``min_scale``."""
    def update(updates, state, params):
        out = {}
        for k, u in updates.items():
            rms = params[k].square().mean().sqrt()
            out[k] = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)
        return out, state

    return Transform(_empty, update)


def adafactor(learning_rate: Union[float, Schedule], weight_decay_rate: Optional[float] = None,
              decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
              clipping_threshold: float = 1.0, multiply_by_parameter_scale: bool = True,
              eps: float = 1e-30) -> Transform:
    """optax.adafactor with its defaults (no momentum): factored rms,
    block-rms clipping, ``* lr``, parameter-scale multiply, decoupled
    ``weight_decay_rate``, then a sign flip."""
    txs = [scale_by_factored_rms(decay_rate, min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        txs.append(clip_by_block_rms(clipping_threshold))
    txs.append(scale_by_learning_rate(learning_rate, flip_sign=False))
    if multiply_by_parameter_scale:
        txs.append(scale_by_param_block_rms())
    if weight_decay_rate is not None:
        txs.append(add_decayed_weights(weight_decay_rate))
    txs.append(Transform(_empty, lambda u, s, p: ({k: t.neg_() for k, t in u.items()}, s)))
    return chain(*txs)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """``p += u`` in place, for every parameter."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
