"""Flow-matching (rectified-flow) Euler sampling as plan rows.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/flow.py``.
SD3-class transformers (``models/mmdit.py``) are trained on the linear path
``x_t = (1 - sigma) x0 + sigma eps`` and predict the velocity ``v = eps -
x0``.  Explicit Euler on that ODE is linear in (x, v):

    x'  = x + (sigma_next - sigma) * v
    x0  = x - sigma * v

so each step is one :class:`StepRow` and the engine's loop runs it as any
other plan.  The sigma grid is uniform from 1 down to 1/T, passed through
the resolution shift ``shift * s / (1 + (shift - 1) * s)``; the model's
timestep is ``sigma * T``, a float that nothing rounds.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow


def flow_sigmas(num_steps: int, *, shift: float = 3.0,
                num_train_timesteps: int = 1000) -> np.ndarray:
    """[num_steps + 1] shifted sigma grid, descending, trailing 0.0."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    T = num_train_timesteps
    sig = np.linspace(1.0, 1.0 / T, num_steps, dtype=np.float64)
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    return np.concatenate([sig, [0.0]])


def flow_transition_row(sigma: float, sigma_next: float, *, num_train_timesteps: int = 1000,
                        tag: str = "") -> StepRow:
    """One explicit-Euler transition sigma -> sigma_next on the flow path
    (memoryless; the unit every flow plan composer is built from)."""
    s, s_next = float(sigma), float(sigma_next)
    return StepRow(
        timestep=s * num_train_timesteps,
        in_scale=1.0,
        w_sample=1.0,
        w_eps=s_next - s,
        cm_sample=1.0,
        cm_eps=s_next - s,
        cx_sample=1.0,
        cx_eps=-s,
        push=True,
        scheduler="flow_euler",
        tag=tag,
    )


def flow_euler_rows(sigmas: np.ndarray, *, num_train_timesteps: int = 1000,
                    tag: str = "") -> List[StepRow]:
    """One Euler row per sigma transition; model output = velocity."""
    sig = np.asarray(sigmas, np.float64)
    return [flow_transition_row(float(sig[i]), float(sig[i + 1]),
                                num_train_timesteps=num_train_timesteps, tag=tag)
            for i in range(len(sig) - 1)]
