"""The trainer's optimizers (``training/optim.py``) against optax, given the
same gradients: the warmup schedule, the global-norm clip, AdamW, Adafactor
with optax's defaults, and each optimizer chain as both trainers build it.

Tolerances: the two sides run the same fp32 arithmetic on the same numbers
and differ only where XLA and torch round a power or a sum differently, a
few ulp; parameters are compared within 1e-6 relative to their size plus
1e-7 after every step.  The 8-bit AdamW's moments are int8 codes: an ulp
can move a moment across a code boundary, so one entry in 10^4 may be off,
by at most 1% of the learning rate.
"""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_close, randn
from sonicdiffusionbayeslab_torch.training import optim
from sonicdiffusionbayeslab_torch.training import trainer as TT
from sonicdiffusionbayeslab_tpu.training import trainer as JT

# A small tree with every kind of leaf: 1-D, 2-D under and over
# Adafactor's factoring size (128), and a 4-D conv kernel over it.
SHAPES = {"bias": (9,), "small": (5, 7), "wide": (128, 160), "conv": (160, 130, 3, 3)}


def _tree(seed, scale=1.0):
    return {k: randn(s, seed + i, scale) for i, (k, s) in enumerate(SHAPES.items())}


def _run(tx_jax, tx_torch, steps=4, grad_scale=1.0):
    """Both transforms over ``steps`` random gradient trees; yields the
    params of both sides after each step."""
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = tx_jax.init(jp), tx_torch.init(tp)
    for step in range(steps):
        g = _tree(100 + 10 * step, grad_scale)
        ju, js = tx_jax.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tx_torch.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tu)
        yield step, jp, tp


def _assert_params(jp, tp, rtol=1e-6, atol=1e-7, flips=None):
    """Every parameter within ``atol + rtol * |jax|``; with ``flips`` =
    (share, bound), that share of the entries may be off by up to
    ``bound``: an int8 moment whose value sits at a code boundary rounds
    to the neighbouring code on an ulp's difference."""
    for k in jp:
        want, got = np.asarray(jp[k]), tp[k].numpy()
        if flips is None:
            assert_close(got, want, atol, rtol)
            continue
        err = np.abs(got - want)
        off = err > atol + rtol * np.abs(want)
        assert off.mean() <= flips[0] and err.max() <= flips[1], (k, off.sum(), err.max())


def test_linear_schedule_warmup_starts_at_zero():
    want = optax.linear_schedule(0.0, 1e-4, 100)
    got = optim.linear_schedule(0.0, 1e-4, 100)
    for count in (0, 1, 2, 50, 99, 100, 101, 1000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7)
    assert got(0) == 0.0


@pytest.mark.parametrize("grad_scale", [0.01, 1.0])  # norm below and above max_norm
def test_clip_by_global_norm_matches_optax(grad_scale):
    g = _tree(3, grad_scale)
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                    None)
    got, _ = optim.clip_by_global_norm(1.0).update(
        {k: torch.from_numpy(v) for k, v in g.items()}, None, None)
    for k in g:
        assert_close(got[k], np.asarray(want[k]), 1e-8, 1e-6)
    norm = float(optim.global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    np.testing.assert_allclose(norm, float(optax.global_norm(g)), rtol=1e-6)
    if grad_scale == 1.0:  # clipped: no epsilon in the scale, unlike clip_grad_norm_
        clipped = float(optim.global_norm(got))
        np.testing.assert_allclose(clipped, 1.0, rtol=1e-6)


def test_adamw_with_warmup_and_clip_matches_optax():
    sched_j, sched_t = optax.linear_schedule(0.0, 1e-2, 3), optim.linear_schedule(0.0, 1e-2, 3)
    tj = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched_j, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    tt = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adamw(sched_t, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    for step, jp, tp in _run(tj, tt, steps=5):
        _assert_params(jp, tp)
        if step == 0:  # warmup's count 0: lr 0, the parameters do not move
            for k, v in _tree(0).items():
                assert torch.equal(tp[k], torch.from_numpy(v))


@pytest.mark.parametrize("weight_decay_rate", [None, 1e-2])
def test_adafactor_matches_optax_defaults(weight_decay_rate):
    """Factored second moments for the two leaves whose two largest dims
    are >= 128, full ones for the others; decay 0.8, block-rms clipping
    at 1, the parameter-scale multiply, no momentum."""
    tj = optax.adafactor(learning_rate=1e-2, weight_decay_rate=weight_decay_rate)
    tt = optim.adafactor(1e-2, weight_decay_rate=weight_decay_rate)
    state = tt.init({k: torch.zeros(s) for k, s in SHAPES.items()})
    stats = state[0]["stats"]
    assert set(stats["wide"]) == {"v_row", "v_col"} and set(stats["conv"]) == {"v_row", "v_col"}
    assert set(stats["small"]) == {"v"} and set(stats["bias"]) == {"v"}
    for _, jp, tp in _run(tj, tt, steps=4, grad_scale=0.3):
        _assert_params(jp, tp)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "adamw8bit"])
@pytest.mark.parametrize("warmup,clip", [(0, 1.0), (2, 0.0)])
def test_trainer_optimizer_chains_match(optimizer, warmup, clip):
    """Each trainer's own chain (``_make_optimizer``) from one TrainConfig:
    the clip (or none), the warmup schedule, the optimizer."""
    kw = dict(optimizer=optimizer, warmup_steps=warmup, max_grad_norm=clip,
              learning_rate=1e-2, weight_decay=1e-2)
    tj = JT.DiffusionTrainer._make_optimizer(types.SimpleNamespace(config=JT.TrainConfig(**kw)))
    tt = TT.DiffusionTrainer._make_optimizer(types.SimpleNamespace(config=TT.TrainConfig(**kw)))
    flips = (1e-4, 1e-2 * kw["learning_rate"]) if optimizer == "adamw8bit" else None
    for _, jp, tp in _run(tj, tt, steps=3, grad_scale=0.5):
        _assert_params(jp, tp, flips=flips)
