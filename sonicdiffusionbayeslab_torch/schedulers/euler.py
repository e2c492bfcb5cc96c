"""Euler, Euler-ancestral and Heun (k-diffusion style) as plan rows.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/euler.py``.
These samplers work in sigma space: the carried sample is
``x = x0 + sigma * eps`` (Karras convention), the model input is scaled by
``1/sqrt(sigma^2 + 1)`` each step (``in_scale``), and the initial N(0, 1)
latents by ``init_noise_sigma = sqrt(sigma_max^2 + 1)``
(``SamplePlan.init_scale``): diffusers EulerDiscrete semantics for
"leading" spacing.

Per step sigma -> sigma':

    x0  = x - sigma * eps                         (epsilon prediction)
    x'  = (sigma'/sigma) * x + (1 - sigma'/sigma) * x0       -- Euler

The ancestral variant steps to ``sigma_down`` and adds fresh noise scaled
by ``sigma_up`` (diffusers EulerAncestral):

    sigma_up   = sqrt(sigma'^2 * (sigma^2 - sigma'^2) / sigma^2)
    sigma_down = sqrt(sigma'^2 - sigma_up^2)
    x' = (sigma_down/sigma) x + (1 - sigma_down/sigma) x0 + sigma_up * noise

Both are linear in (x, x0, noise): one StepRow each, history depth 1.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule


def euler_sigmas(schedule: NoiseSchedule, ts: np.ndarray) -> np.ndarray:
    """Karras sigmas at (possibly float) timesteps via interpolation on the
    training table, with the trailing 0.0 (diffusers EulerDiscrete)."""
    T = schedule.config.num_train_timesteps
    table = np.sqrt((1.0 - schedule.alphas_cumprod) / schedule.alphas_cumprod)
    sig = np.interp(np.asarray(ts, np.float64), np.arange(T, dtype=np.float64), table)
    return np.concatenate([sig, [0.0]])


def _x0_coeffs(s: float, prediction_type: str):
    """x0 from the model output on the *scaled* input is equivalently a
    linear function of the carried (unscaled) sigma-space x and the raw
    output (diffusers EulerDiscrete/HeunDiscrete conversions):
      eps-pred:  x0 = x - sigma * eps
      v-pred:    x0 = x / (sigma^2+1) - sigma/sqrt(sigma^2+1) * v
      sample:    x0 = model_output (already data space)"""
    if prediction_type == "epsilon":
        return (1.0, -s)
    if prediction_type == "v_prediction":
        return (1.0 / (s * s + 1.0), -s / np.sqrt(s * s + 1.0))
    if prediction_type == "sample":
        return (0.0, 1.0)
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def euler_rows(
    schedule: NoiseSchedule,
    ts: np.ndarray,
    *,
    ancestral: bool = False,
    prediction_type: str = "epsilon",
    sigmas: np.ndarray | None = None,  # override (Karras grid); len(ts)+1
    tag: str = "",
) -> List[StepRow]:
    sig = euler_sigmas(schedule, ts) if sigmas is None else np.asarray(sigmas, np.float64)
    rows: List[StepRow] = []
    for i, t in enumerate(float(x) for x in ts):
        s, s_next = sig[i], sig[i + 1]
        cm = _x0_coeffs(s, prediction_type)

        w_noise = 0.0
        if ancestral and s_next > 0:
            var_up = s_next**2 * (s**2 - s_next**2) / s**2
            s_up = float(np.sqrt(max(var_up, 0.0)))
            s_to = float(np.sqrt(max(s_next**2 - s_up**2, 0.0)))
            w_noise = s_up
        else:
            s_to = s_next

        ratio = s_to / s
        rows.append(
            StepRow(
                timestep=float(t),
                in_scale=float(1.0 / np.sqrt(s * s + 1.0)),
                w_sample=float(ratio),
                w_hist=(float(1.0 - ratio),),
                w_noise=float(w_noise),
                cm_sample=float(cm[0]),
                cm_eps=float(cm[1]),
                cx_sample=float(cm[0]),
                cx_eps=float(cm[1]),
                push=True,
                scheduler="euler_ancestral" if ancestral else "euler",
                tag=tag,
            )
        )
    return rows


def heun_rows(
    schedule: NoiseSchedule,
    ts: np.ndarray,
    *,
    prediction_type: str = "epsilon",
    sigmas: np.ndarray | None = None,
    tag: str = "",
) -> List[StepRow]:
    """Heun's 2nd-order method (diffusers HeunDiscrete): each sigma
    transition costs two model evals — an Euler predictor row that also
    saves the start sample, then a trapezoidal corrector row evaluated at
    the *target* sigma:

        x_mid   = (s'/s) x + (1 - s'/s) x0_1          (predictor, saves x)
        x_next  = x + (s'-s)/2 * (d1 + d2),
        d1 = (x - m1)/s,  d2 = (x_mid - m2)/s'

    Both rows are linear in (x, saved, hist) — see plan.py.  The final
    transition (s' = 0) is a single Euler row, so NFE = 2*num_steps - 1.

    The update weights act on the pushed x0 predictions (d1 = (x - m1)/s),
    so they are prediction-type independent: v-prediction / sample support
    is entirely in the per-row conversion coefficients (``_x0_coeffs``).
    """
    sig = euler_sigmas(schedule, ts) if sigmas is None else np.asarray(sigmas, np.float64)
    rows: List[StepRow] = []
    for i, t in enumerate(float(x) for x in ts):
        s, s2 = sig[i], sig[i + 1]
        ratio = s2 / s
        cs, ce = _x0_coeffs(s, prediction_type)
        common = dict(push=True, scheduler="heun", tag=tag)
        if s2 == 0.0:  # last transition: plain Euler
            rows.append(StepRow(
                timestep=t, in_scale=float(1.0 / np.sqrt(s * s + 1.0)),
                w_sample=float(ratio), w_hist=(float(1.0 - ratio),),
                cm_sample=float(cs), cm_eps=float(ce),
                cx_sample=float(cs), cx_eps=float(ce), **common,
            ))
            continue
        t_next = float(ts[i + 1]) if i + 1 < len(ts) else 0.0
        rows.append(StepRow(  # predictor (Euler to s2), saves x
            timestep=t, in_scale=float(1.0 / np.sqrt(s * s + 1.0)),
            w_sample=float(ratio), w_hist=(float(1.0 - ratio),),
            cm_sample=float(cs), cm_eps=float(ce),
            cx_sample=float(cs), cx_eps=float(ce), save_cur=True, **common,
        ))
        half = (s2 - s) / 2.0
        cs2, ce2 = _x0_coeffs(s2, prediction_type)
        rows.append(StepRow(  # corrector at s2 from the saved start sample
            timestep=t_next, in_scale=float(1.0 / np.sqrt(s2 * s2 + 1.0)),
            w_sample=float(half / s2),
            w_saved=float(1.0 + half / s),
            w_hist=(float(-half / s2), float(-half / s)),
            s_x=0.0, s_saved=1.0,
            cm_sample=float(cs2), cm_eps=float(ce2),
            cx_sample=float(cs2), cx_eps=float(ce2), **common,
        ))
    return rows


def init_noise_sigma(schedule: NoiseSchedule, ts: np.ndarray) -> float:
    """diffusers EulerDiscrete.init_noise_sigma for leading/default spacing."""
    sig_max = float(euler_sigmas(schedule, ts)[0])
    if schedule.config.timestep_spacing in ("linspace", "trailing"):
        return sig_max
    return float(np.sqrt(sig_max**2 + 1.0))
