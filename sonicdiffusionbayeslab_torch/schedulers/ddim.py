"""DDIM update as plan rows (deterministic, or ancestral with ``eta``).

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/ddim.py``.
Standard diffusers DDIM semantics: ``prev_t = t - T // num_steps``,
eta-scaled variance, no x0 clipping.  Each step is memoryless and linear in
(sample, model output, noise).  Rows still push the x0 prediction into the
history ring, so that a composed plan can warm a downstream DPM scheduler's
multistep history during a DDIM phase.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import (
    NoiseSchedule,
    eps_conversion_coeffs,
    x0_conversion_coeffs,
)


def ddim_transition_row(
    schedule: NoiseSchedule,
    t: int,
    prev_t: int,
    *,
    eta: float = 0.0,
    prediction_type: str = "epsilon",
    unet_timestep: Optional[int] = None,
    tag: str = "",
) -> StepRow:
    """One DDIM transition t -> prev_t (prev_t < 0 means the final clean step)."""
    acp_t = float(schedule.acp(t))
    acp_prev = float(schedule.acp_or_final(prev_t))

    a_s, a_e = x0_conversion_coeffs(schedule, t, prediction_type)
    e_s, e_e = eps_conversion_coeffs(schedule, t, prediction_type)

    variance = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    std = eta * np.sqrt(max(variance, 0.0))
    c_x0 = np.sqrt(acp_prev)
    c_eps = np.sqrt(max(1.0 - acp_prev - std**2, 0.0))

    # prev = c_x0 * x0 + c_eps * eps_hat + std * noise, expanded over (x, mo).
    return StepRow(
        timestep=int(t if unet_timestep is None else unet_timestep),
        w_sample=float(c_x0 * a_s + c_eps * e_s),
        w_eps=float(c_x0 * a_e + c_eps * e_e),
        w_hist=(),
        w_noise=float(std),
        cm_sample=float(a_s),
        cm_eps=float(a_e),
        cx_sample=float(a_s),
        cx_eps=float(a_e),
        push=True,
        scheduler="ddim",
        tag=tag,
    )


def ddim_rows(
    schedule: NoiseSchedule,
    timesteps: Sequence[int],
    num_steps: int,
    *,
    eta: float = 0.0,
    prediction_type: str = "epsilon",
    executed: Optional[Sequence[int]] = None,
    tag: str = "",
) -> List[StepRow]:
    """Rows for a DDIM schedule.  ``executed`` optionally selects a subset of
    step indices (skip-steps semantics: DDIM is timestep-indexed, so each
    executed step keeps its own ``t - T // num_steps`` target)."""
    T = schedule.config.num_train_timesteps
    idxs = range(len(timesteps)) if executed is None else executed
    return [
        ddim_transition_row(
            schedule,
            int(timesteps[i]),
            int(timesteps[i]) - T // num_steps,
            eta=eta,
            prediction_type=prediction_type,
            tag=tag,
        )
        for i in idxs
    ]
