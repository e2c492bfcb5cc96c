"""DEIS (logrho) multistep as plan rows (orders 1-3).

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/deis.py``:
the diffusers ``DEISMultistepScheduler`` update family (Zhang & Chen 2022,
algorithm "deis", solver "logrho") as per-step linear coefficients.

With rho = sigma/alpha (the Karras sigma), the probability-flow ODE in
x/alpha coordinates is d(x/alpha)/drho = eps.  DEIS-logrho integrates it
with an Adams-Bashforth step whose polynomial basis is Lagrange in log-rho:

    x_t = alpha_t * ( x_s0/alpha_s0 + sum_k I_k * eps_k )
    I_k = Integral_{rho_s0}^{rho_t} prod_{j!=k} (ln r - ln rho_j)
                                    / (ln rho_k - ln rho_j) dr

The antiderivatives are closed-form, so every step is linear in (sample,
history epsilons): one StepRow.  The history ring carries the implied
epsilon.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.dpm import DpmLadder, simulate_orders
from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule


def _ind2(t: float, b: float, c: float) -> float:
    """Integral of (ln r - ln c)/(ln b - ln c) dr, antiderivative at r=t."""
    if t <= 0.0:
        return 0.0  # r*(ln r - ...) -> 0 as r -> 0
    return t * (np.log(t) - np.log(c) - 1.0) / (np.log(b) - np.log(c))


def _ind3(t: float, b: float, c: float, d: float) -> float:
    """Antiderivative at r=t of
    (ln r - ln c)(ln r - ln d) / ((ln b - ln c)(ln b - ln d))."""
    if t <= 0.0:
        return 0.0
    lt, lc, ld = np.log(t), np.log(c), np.log(d)
    lb = np.log(b)
    # Integral of (u - lc)(u - ld) with u = ln r:
    #   r*[ (u^2 - 2u + 2) - (lc + ld)(u - 1) + lc*ld ]
    num = (lt * lt - 2.0 * lt + 2.0) - (lc + ld) * (lt - 1.0) + lc * ld
    return t * num / ((lb - lc) * (lb - ld))


def _deis_weights(order: int, rho: np.ndarray, s0: int, t: int) -> np.ndarray:
    """History weights (w[0]=most recent eps) for the s0 -> t transition."""
    w = np.zeros(3, dtype=np.float64)
    if order == 1:
        w[0] = rho[t] - rho[s0]
        return w
    if order == 2:
        b, c = rho[s0], rho[s0 - 1]
        w[0] = _ind2(rho[t], b, c) - _ind2(rho[s0], b, c)
        w[1] = _ind2(rho[t], c, b) - _ind2(rho[s0], c, b)
        return w
    if order == 3:
        r0, r1, r2 = rho[s0], rho[s0 - 1], rho[s0 - 2]
        w[0] = _ind3(rho[t], r0, r1, r2) - _ind3(rho[s0], r0, r1, r2)
        w[1] = _ind3(rho[t], r1, r0, r2) - _ind3(rho[s0], r1, r0, r2)
        w[2] = _ind3(rho[t], r2, r0, r1) - _ind3(rho[s0], r2, r0, r1)
        return w
    raise ValueError(f"DEIS supports orders 1-3, got {order}")


def deis_rows(
    schedule: NoiseSchedule,
    ladder: DpmLadder,
    positions: Sequence[int],
    *,
    solver_order: int = 2,
    final_sigmas_type: str = "zero",
    prediction_type: str = "epsilon",
    lower_order_final: bool = True,
    euler_at_final: bool = False,
    unet_timesteps: Optional[Sequence[int]] = None,
    orders: Optional[Sequence[int]] = None,
    lower_order_nums0: int = 0,
    tag: str = "",
) -> List[StepRow]:
    """Rows executing ladder ``positions`` (pos -> pos+1 transitions); the
    same warm-up / end-of-schedule order demotions as DPM (diffusers DEIS
    shares that bookkeeping)."""
    positions = [int(p) for p in positions]
    L = len(ladder.ts)
    if orders is None:
        orders = simulate_orders(
            positions, L, solver_order,
            lower_order_final=lower_order_final,
            euler_at_final=euler_at_final,
            final_sigmas_type=final_sigmas_type,
            lower_order_nums0=lower_order_nums0,
        )
    if unet_timesteps is None:
        unet_timesteps = [float(ladder.ts[p]) for p in positions]

    alpha, sig_t, rho = ladder.alpha, ladder.sigma_t, ladder.sigmas
    rows: List[StepRow] = []
    for k, (pos, order) in enumerate(zip(positions, orders)):
        s0, t = pos, pos + 1
        w = _deis_weights(order, rho, s0, t) * alpha[t]
        a_s0, s_s0 = alpha[s0], sig_t[s0]

        # Ring content: implied epsilon at the current level.
        if prediction_type == "epsilon":
            cm = (0.0, 1.0)
        elif prediction_type == "v_prediction":
            cm = (s_s0, a_s0)
        elif prediction_type == "sample":
            cm = (1.0 / s_s0, -a_s0 / s_s0)
        else:
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        # x0 capture (introspection contract).
        if prediction_type == "epsilon":
            cx = (1.0 / a_s0, -s_s0 / a_s0)
        elif prediction_type == "v_prediction":
            cx = (a_s0, -s_s0)
        else:
            cx = (0.0, 1.0)

        rows.append(
            StepRow(
                timestep=float(unet_timesteps[k]),
                w_sample=float(alpha[t] / alpha[s0]),
                w_eps=0.0,
                w_hist=tuple(float(x) for x in w[: max(solver_order, order)]),
                cm_sample=float(cm[0]),
                cm_eps=float(cm[1]),
                cx_sample=float(cx[0]),
                cx_eps=float(cx[1]),
                push=True,
                scheduler="deis",
                tag=tag,
            )
        )
    return rows
