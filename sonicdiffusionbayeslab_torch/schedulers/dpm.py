"""DPM-Solver(++) multistep as plan rows (orders 1-3, deterministic and SDE++).

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/dpm.py``.
The multistep state (history ring, warm-up order, end-of-schedule
demotions) is simulated at plan time and each update is expanded into
linear coefficients over (sample, history entries, noise).

"Ladder" = the run's noise-level sequence: ``sigmas[j]`` is the
Karras-convention sigma at ladder position ``j`` (len(ts) + 1 entries, the
last per ``final_sigmas_type``); a step moves position ``j`` to ``j+1``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import (
    NoiseSchedule,
    karras_sigmas,
    sigma_to_t,
)


@dataclasses.dataclass(frozen=True)
class DpmLadder:
    ts: np.ndarray  # int timesteps, descending, len L
    sigmas: np.ndarray  # Karras sigmas, len L+1

    @property
    def alpha(self) -> np.ndarray:  # normalised alpha_t = 1/sqrt(1+sig^2)
        return 1.0 / np.sqrt(self.sigmas**2 + 1.0)

    @property
    def sigma_t(self) -> np.ndarray:  # normalised sigma_t = sig * alpha_t
        return self.sigmas * self.alpha

    @property
    def lam(self) -> np.ndarray:  # lambda = log(alpha) - log(sigma_t); +inf at sigma 0
        with np.errstate(divide="ignore"):
            return np.log(self.alpha) - np.log(self.sigma_t)


def _final_sigma(schedule: NoiseSchedule, final_sigmas_type: str) -> float:
    if final_sigmas_type == "zero":
        return 0.0
    if final_sigmas_type == "sigma_min":
        a0 = schedule.alphas_cumprod[0]
        return float(np.sqrt((1.0 - a0) / a0))
    raise ValueError(f"unknown final_sigmas_type {final_sigmas_type!r}")


def make_ladder(schedule: NoiseSchedule, ts: Sequence[int],
                final_sigmas_type: str = "zero") -> DpmLadder:
    ts = np.asarray(ts, dtype=np.int64)
    sig = schedule.kar_sigma(ts)
    last = _final_sigma(schedule, final_sigmas_type)
    return DpmLadder(ts=ts, sigmas=np.concatenate([sig, [last]]).astype(np.float64))


def make_karras_ladder(schedule: NoiseSchedule, num_steps: int,
                       final_sigmas_type: str = "zero", rho: float = 7.0) -> DpmLadder:
    """Karras-spaced ladder with fractional conditioning timesteps
    (diffusers ``use_karras_sigmas=True``)."""
    table = np.sqrt((1.0 - schedule.alphas_cumprod) / schedule.alphas_cumprod)
    sig = karras_sigmas(float(table[0]), float(table[-1]), num_steps, rho)
    ts = sigma_to_t(schedule, sig)
    last = _final_sigma(schedule, final_sigmas_type)
    return DpmLadder(ts=ts, sigmas=np.concatenate([sig, [last]]).astype(np.float64))


def simulate_orders(
    positions: Sequence[int], full_len: int, solver_order: int, *,
    lower_order_final: bool = True, euler_at_final: bool = False,
    final_sigmas_type: str = "zero", lower_order_nums0: int = 0,
) -> List[int]:
    """Per-step solver order: warm-up via ``lower_order_nums`` plus the
    ``lower_order_final`` / ``lower_order_second`` demotions."""
    orders: List[int] = []
    lon = lower_order_nums0
    for pos in positions:
        lof = (pos == full_len - 1) and (
            euler_at_final or (lower_order_final and full_len < 15) or final_sigmas_type == "zero"
        )
        los = (pos == full_len - 2) and lower_order_final and full_len < 15
        if solver_order == 1 or lon < 1 or lof:
            order = 1
        elif solver_order == 2 or lon < 2 or los:
            order = 2
        else:
            order = 3
        orders.append(order)
        if lon < solver_order:
            lon += 1
    return orders


def _mcoeffs(order: int, h: float, h0: float, h1: float, alg: str, solver_type: str):
    """History-entry weights (w[0] = most recent) and the noise weight of one
    update; the sample weight is computed by the caller."""
    em1 = np.expm1(-h)
    ep1 = np.expm1(h)
    w = np.zeros(3, dtype=np.float64)

    if alg == "dpmsolver++":
        w[0] += -em1  # times alpha_t outside
        if order >= 2:
            r0 = h0 / h
            if solver_type == "midpoint":
                cD1 = -0.5 * em1
            elif solver_type == "heun":
                cD1 = em1 / h + 1.0
            else:
                raise ValueError(f"unknown solver_type {solver_type!r}")
            if order == 2:  # D1 = (m0 - m1) / r0
                w[0] += cD1 / r0
                w[1] -= cD1 / r0
            else:
                r1 = h1 / h
                cD1 = em1 / h + 1.0
                cD2 = -((em1 + h) / h**2 - 0.5)
                c1 = r0 / (r0 + r1)
                w[0] += cD1 * (1 + c1) / r0
                w[1] += cD1 * (-(1 + c1) / r0 - c1 / r1)
                w[2] += cD1 * (c1 / r1)
                w[0] += cD2 / (r0 * (r0 + r1))
                w[1] += cD2 * (-1.0 / (r0 * (r0 + r1)) - 1.0 / (r1 * (r0 + r1)))
                w[2] += cD2 / (r1 * (r0 + r1))
        return w, 0.0
    if alg == "dpmsolver":
        w[0] += -ep1  # times sigma_t outside
        if order >= 2:
            r0 = h0 / h
            if solver_type == "midpoint":
                cD1 = -0.5 * ep1
            elif solver_type == "heun":
                cD1 = -(ep1 / h - 1.0)
            else:
                raise ValueError(f"unknown solver_type {solver_type!r}")
            if order == 2:
                w[0] += cD1 / r0
                w[1] -= cD1 / r0
            else:
                r1 = h1 / h
                cD1 = -(ep1 / h - 1.0)
                cD2 = -((ep1 - h) / h**2 - 0.5)
                c1 = r0 / (r0 + r1)
                w[0] += cD1 * (1 + c1) / r0
                w[1] += cD1 * (-(1 + c1) / r0 - c1 / r1)
                w[2] += cD1 * (c1 / r1)
                w[0] += cD2 / (r0 * (r0 + r1))
                w[1] += cD2 * (-1.0 / (r0 * (r0 + r1)) - 1.0 / (r1 * (r0 + r1)))
                w[2] += cD2 / (r1 * (r0 + r1))
        return w, 0.0
    if alg == "sde-dpmsolver++":
        em2 = np.expm1(-2.0 * h)
        w[0] += -em2  # times alpha_t outside
        if order >= 2:
            r0 = h0 / h
            if solver_type == "midpoint":
                cD1 = -0.5 * em2
            elif solver_type == "heun":
                cD1 = em2 / (-2.0 * h) + 1.0
            else:
                raise ValueError(f"unknown solver_type {solver_type!r}")
            w[0] += cD1 / r0
            w[1] -= cD1 / r0
            if order >= 3:
                raise NotImplementedError("sde-dpmsolver++ supports orders 1-2")
        return w, np.sqrt(-em2)  # noise weight times sigma_t outside
    raise NotImplementedError(f"algorithm_type {alg!r} not supported")


def dpm_rows(
    schedule: NoiseSchedule,
    ladder: DpmLadder,
    positions: Sequence[int],
    *,
    solver_order: int = 2,
    algorithm_type: str = "dpmsolver++",
    solver_type: str = "midpoint",
    final_sigmas_type: str = "zero",
    prediction_type: str = "epsilon",
    lower_order_final: bool = True,
    euler_at_final: bool = False,
    unet_timesteps: Optional[Sequence[int]] = None,
    orders: Optional[Sequence[int]] = None,
    lower_order_nums0: int = 0,
    tag: str = "",
) -> List[StepRow]:
    """Rows for executing ladder ``positions`` (each moves pos -> pos+1)."""
    positions = list(int(p) for p in positions)
    L = len(ladder.ts)
    if orders is None:
        orders = simulate_orders(
            positions, L, solver_order, lower_order_final=lower_order_final,
            euler_at_final=euler_at_final, final_sigmas_type=final_sigmas_type,
            lower_order_nums0=lower_order_nums0,
        )
    if unet_timesteps is None:
        unet_timesteps = [float(ladder.ts[p]) for p in positions]

    alpha, sig_t, lam = ladder.alpha, ladder.sigma_t, ladder.lam
    is_pp = algorithm_type.endswith("++")
    rows: List[StepRow] = []
    for k, (pos, order) in enumerate(zip(positions, orders)):
        s0, t = pos, pos + 1
        h = lam[t] - lam[s0]
        h0 = lam[s0] - lam[s0 - 1] if order >= 2 else 0.0
        h1 = lam[s0 - 1] - lam[s0 - 2] if order >= 3 else 0.0
        w_m, w_noise = _mcoeffs(order, h, h0, h1, algorithm_type, solver_type)

        if algorithm_type == "dpmsolver++":
            w_sample = sig_t[t] / sig_t[s0]
            w_m = w_m * alpha[t]
        elif algorithm_type == "sde-dpmsolver++":
            w_sample = sig_t[t] / sig_t[s0] * np.exp(-h)
            w_m = w_m * alpha[t]
            w_noise = w_noise * sig_t[t]
        else:
            w_sample = alpha[t] / alpha[s0]
            w_m = w_m * sig_t[t]

        # The ring holds x0 for the ++ family and eps otherwise, expressed
        # over (sample, model output) at the current noise level.
        a_s0, s_s0 = alpha[s0], sig_t[s0]
        if prediction_type == "epsilon":
            cm = (1.0 / a_s0, -s_s0 / a_s0) if is_pp else (0.0, 1.0)
        elif prediction_type == "v_prediction":
            cm = (a_s0, -s_s0) if is_pp else (s_s0, a_s0)
        elif prediction_type == "sample":
            cm = (0.0, 1.0) if is_pp else (1.0 / s_s0, -a_s0 / s_s0)
        else:
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        # x0 capture is always the data prediction.
        if prediction_type == "epsilon":
            cx = (1.0 / a_s0, -s_s0 / a_s0)
        elif prediction_type == "v_prediction":
            cx = (a_s0, -s_s0)
        else:
            cx = (0.0, 1.0)

        rows.append(
            StepRow(
                timestep=float(unet_timesteps[k]),
                w_sample=float(w_sample),
                w_eps=0.0,
                w_hist=tuple(float(x) for x in w_m[:max(solver_order, order)]),
                w_noise=float(w_noise),
                cm_sample=float(cm[0]),
                cm_eps=float(cm[1]),
                cx_sample=float(cx[0]),
                cx_eps=float(cx[1]),
                push=True,
                scheduler="dpm",
                tag=tag,
            )
        )
    return rows
