"""UniPC (unified predictor-corrector, Zhao et al. 2023) as plan rows.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/unipc.py``:
data prediction (predict_x0) with the B(h) variants ``bh1``/``bh2``, the
diffusers default.

At step k (incoming latents = the uncorrected prediction x_k, saved
buffer = the corrected x_{k-1}):

    m_k  = convert(eps, x_k)                      # data prediction, hist push
    x^c  = A * saved + sum_j B[j] * hist[j]       # UniC  (k = 0: x^c = x_k)
    x_{k+1} = Cs * x^c + sum_j D[j] * hist[j]     # UniP
    saved'  = x^c

Both updates are linear, so they fuse into one StepRow with ``w_saved =
Cs*A``, ``w_hist = Cs*B + D``, ``s_saved = A``, ``s_hist = B``; hist[0] is
m_k (pushed this step), hist[j] is m_{k-j}.  The predictor order ramps
1..solver_order and (``lower_order_final``) anneals to 1 at the end; the
corrector at step k uses step k-1's predictor order (diffusers'
UniPCMultistepScheduler).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.dpm import DpmLadder
from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule


def unipc_orders(num_steps: int, solver_order: int, lower_order_final: bool = True) -> List[int]:
    """Per-step predictor order (diffusers ``this_order`` sequence)."""
    orders: List[int] = []
    lon = 0
    for i in range(num_steps):
        this = min(solver_order, num_steps - i) if lower_order_final else solver_order
        orders.append(max(1, min(this, lon + 1)))
        if lon < solver_order:
            lon += 1
    return orders


def _bh_system(h: float, n: int, rks: np.ndarray, variant: str):
    """R (n x n over rks) and b (n) of the UniPC B(h) linear system, plus
    (h_phi_1, B_h).  ``rks`` must already include the trailing 1.0."""
    hh = -h  # predict_x0 sign convention
    h_phi_1 = np.expm1(hh)
    if variant == "bh1":
        B_h = hh
    elif variant == "bh2":
        B_h = np.expm1(hh)
    else:
        raise ValueError(f"unknown UniPC variant {variant!r}")
    R, b = [], []
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1.0
    for i in range(1, n + 1):
        R.append(rks ** (i - 1))
        b.append(h_phi_k * fact / B_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return np.stack(R), np.asarray(b), h_phi_1, B_h


def _unip_weights(ladder: DpmLadder, pos: int, order: int, variant: str):
    """(Cs, D): sample coefficient and hist weights of the UniP update
    pos -> pos+1.  hist[0] = m at pos, hist[j] = m at pos-j."""
    lam, alpha, sig_t = ladder.lam, ladder.alpha, ladder.sigma_t
    s0, t = pos, pos + 1
    h = lam[t] - lam[s0]
    rks = np.array([(lam[s0 - i] - lam[s0]) / h for i in range(1, order)] + [1.0])
    D = np.zeros(order if order > 1 else 1, dtype=np.float64)
    _, _, h_phi_1, B_h = _bh_system(h, 1, rks, variant)
    Cs = sig_t[t] / sig_t[s0]
    D[0] += -alpha[t] * h_phi_1
    if order >= 2:
        if order == 2:
            rhos = np.array([0.5])
        else:
            R, b, _, _ = _bh_system(h, order, rks, variant)
            rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
        for i in range(order - 1):
            c = alpha[t] * B_h * rhos[i] / rks[i]
            # - a_t*B_h*rhos[i] * (hist[i+1] - hist[0]) / rk_i
            D[0] += c
            D[i + 1] -= c
    return float(Cs), D


def _unic_weights(ladder: DpmLadder, pos: int, order: int, variant: str):
    """(A, B): saved coefficient and hist weights of the UniC correction of
    x at ``pos`` from the corrected sample at ``pos-1``.  hist[0] = m at pos
    (the fresh output), hist[1] = m at pos-1, hist[1+i] = m at pos-1-i."""
    lam, alpha, sig_t = ladder.lam, ladder.alpha, ladder.sigma_t
    s0, t = pos - 1, pos
    h = lam[t] - lam[s0]
    rks = np.array([(lam[s0 - i] - lam[s0]) / h for i in range(1, order)] + [1.0])
    B = np.zeros(order + 1, dtype=np.float64)
    if order == 1:
        rhos = np.array([0.5])
        _, _, h_phi_1, B_h = _bh_system(h, 1, rks, variant)
    else:
        R, b, h_phi_1, B_h = _bh_system(h, order, rks, variant)
        rhos = np.linalg.solve(R, b)
    A = sig_t[t] / sig_t[s0]
    B[1] += -alpha[t] * h_phi_1  # m0' = hist[1]
    for i in range(order - 1):
        c = alpha[t] * B_h * rhos[i] / rks[i]
        # - a_t*B_h*rhos[i] * (hist[1+i+1] - hist[1]) / rk_i
        B[1] += c
        B[2 + i] -= c
    # rhos[-1] * D1_t = rhos[-1] * (hist[0] - hist[1])
    c = alpha[t] * B_h * rhos[-1]
    B[0] -= c
    B[1] += c
    return float(A), B


def unipc_rows(
    schedule: NoiseSchedule,
    ladder: DpmLadder,
    positions: Sequence[int],
    *,
    solver_order: int = 2,
    variant: str = "bh2",
    use_corrector: bool = True,
    lower_order_final: bool = True,
    prediction_type: str = "epsilon",
    tag: str = "",
) -> List[StepRow]:
    """Rows for executing ladder ``positions`` (each pos -> pos+1) with UniPC.

    ``positions`` must be consecutive from 0 (the corrector couples steps).
    """
    positions = [int(p) for p in positions]
    if positions != list(range(positions[0], positions[0] + len(positions))):
        raise ValueError("UniPC requires consecutive ladder positions")
    L = len(positions)
    # Orders ramp from 1 at the first *executed* step (history is empty
    # there regardless of the start position — img2img tails included).
    orders = unipc_orders(L, solver_order, lower_order_final)
    depth = solver_order + 1  # corrector reads hist[order] at most

    alpha, sig_t = ladder.alpha, ladder.sigma_t
    rows: List[StepRow] = []
    for k, pos in enumerate(positions):
        p = orders[k]
        Cs, D = _unip_weights(ladder, pos, p, variant)
        w_hist = np.zeros(depth, dtype=np.float64)
        w_hist[: len(D)] += D

        a_s0, s_s0 = alpha[pos], sig_t[pos]
        if prediction_type == "epsilon":
            cm = (1.0 / a_s0, -s_s0 / a_s0)
        elif prediction_type == "v_prediction":
            cm = (a_s0, -s_s0)
        elif prediction_type == "sample":
            cm = (0.0, 1.0)
        else:
            raise ValueError(f"unknown prediction_type {prediction_type!r}")

        if k == 0 or not use_corrector:
            rows.append(
                StepRow(
                    timestep=float(ladder.ts[pos]),
                    w_sample=float(Cs),
                    w_hist=tuple(float(x) for x in w_hist),
                    cm_sample=float(cm[0]),
                    cm_eps=float(cm[1]),
                    cx_sample=float(cm[0]),
                    cx_eps=float(cm[1]),
                    push=True,
                    w_saved=0.0,
                    s_x=1.0,
                    s_saved=0.0,
                    scheduler="unipc",
                    tag=tag,
                )
            )
            continue

        q = orders[k - 1]  # corrector order = previous predictor order
        A, B = _unic_weights(ladder, pos, q, variant)
        s_hist = np.zeros(depth, dtype=np.float64)
        s_hist[: len(B)] += B
        rows.append(
            StepRow(
                timestep=float(ladder.ts[pos]),
                w_sample=0.0,
                w_hist=tuple(float(x) for x in (Cs * s_hist + w_hist)),
                cm_sample=float(cm[0]),
                cm_eps=float(cm[1]),
                cx_sample=float(cm[0]),
                cx_eps=float(cm[1]),
                push=True,
                w_saved=float(Cs * A),
                s_x=0.0,
                s_saved=float(A),
                s_hist=tuple(float(x) for x in s_hist),
                scheduler="unipc",
                tag=tag,
            )
        )
    return rows
