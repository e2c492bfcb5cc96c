"""LCM (latent consistency model) multistep sampling as plan rows.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/lcm.py``:
diffusers LCM semantics, consistency-boundary-scaled denoising plus fresh
noise injected between steps.  Linear in (sample, x0, noise) per step.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule, x0_conversion_coeffs


def lcm_timesteps(
    num_steps: int,
    num_train_timesteps: int = 1000,
    original_inference_steps: int = 50,
) -> np.ndarray:
    """LCM's skipping-step schedule over the distillation grid."""
    k = num_train_timesteps // original_inference_steps
    origin = np.arange(1, original_inference_steps + 1, dtype=np.int64) * k - 1
    if num_steps > original_inference_steps:
        raise ValueError(
            f"LCM num_steps {num_steps} > original_inference_steps {original_inference_steps}"
        )
    skipping = len(origin) // num_steps
    return origin[::-1][::skipping][:num_steps]


def boundary_scalings(t, timestep_scaling: float = 10.0, sigma_data: float = 0.5):
    """The consistency boundary scalings (c_skip, c_out) at timesteps ``t``
    in float64: with u = t * timestep_scaling, c_skip = sigma_data^2 / (u^2
    + sigma_data^2) and c_out = u / sqrt(u^2 + sigma_data^2), so f(x, 0) = x.
    The plan rows and the distillation step (``training/distillation.py``)
    both take them from here."""
    scaled = np.asarray(t, np.float64) * timestep_scaling
    c_skip = sigma_data**2 / (scaled**2 + sigma_data**2)
    c_out = scaled / np.sqrt(scaled**2 + sigma_data**2)
    return c_skip, c_out


def lcm_rows(
    schedule: NoiseSchedule,
    num_steps: int,
    *,
    original_inference_steps: int = 50,
    timestep_scaling: float = 10.0,
    sigma_data: float = 0.5,
    prediction_type: str = "epsilon",
    tag: str = "",
) -> List[StepRow]:
    ts = lcm_timesteps(num_steps, schedule.config.num_train_timesteps, original_inference_steps)
    rows: List[StepRow] = []
    for i, t in enumerate(ts):
        last = i == len(ts) - 1
        acp_prev = 1.0 if last else float(schedule.acp(int(ts[i + 1])))
        c_skip, c_out = (float(c) for c in boundary_scalings(t, timestep_scaling, sigma_data))
        a_s, a_e = x0_conversion_coeffs(schedule, int(t), prediction_type)

        # denoised = c_out * x0 + c_skip * x; prev = sqrt(acp_prev) * denoised
        # + sqrt(1 - acp_prev) * noise (no noise on the final step).
        s = np.sqrt(acp_prev) if not last else 1.0
        rows.append(
            StepRow(
                timestep=int(t),
                w_sample=float(s * c_skip),
                w_eps=0.0,
                w_hist=(float(s * c_out),),  # applied to the pushed x0 (hist[0])
                w_noise=0.0 if last else float(np.sqrt(1.0 - acp_prev)),
                cm_sample=float(a_s),
                cm_eps=float(a_e),
                cx_sample=float(a_s),
                cx_eps=float(a_e),
                push=True,
                scheduler="lcm",
                tag=tag,
            )
        )
    return rows
