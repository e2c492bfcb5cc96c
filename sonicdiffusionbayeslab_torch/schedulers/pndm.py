"""PNDM (PLMS variant, ``skip_prk_steps=True``) as plan rows.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/pndm.py``.
SD-1.5's default pipeline scheduler, which the ``default`` method runs:
linear-multistep Adams-Bashforth over an epsilon history ring of depth 4,
with the first transition executed twice (plain, then Heun-style averaged)
from a saved sample.  The counter-dependent coefficient choice happens at
plan time, so ``num_steps`` PLMS steps are ``num_steps + 1`` rows (UNet
evaluations).
"""

from __future__ import annotations

from typing import List

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.plan import StepRow
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule


def plms_timesteps(num_steps: int, num_train_timesteps: int = 1000, steps_offset: int = 1) -> np.ndarray:
    """Descending PLMS conditioning timesteps, len num_steps + 1 (second
    schedule entry duplicated, per diffusers PNDM with skip_prk_steps)."""
    ratio = num_train_timesteps // num_steps
    asc = (np.arange(num_steps, dtype=np.int64) * ratio).round().astype(np.int64) + steps_offset
    seq = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])
    return seq[::-1].copy()


def _prev_sample_coeffs(schedule: NoiseSchedule, t_used: int, prev_used: int):
    """PLMS transition: prev = c_sample * sample + c_eps * eps_combined."""
    acp_t = float(schedule.acp(t_used))
    acp_prev = float(schedule.acp_or_final(prev_used))
    c_sample = np.sqrt(acp_prev / acp_t)
    denom = acp_t * np.sqrt(1.0 - acp_prev) + np.sqrt(acp_t * (1.0 - acp_t) * acp_prev)
    c_eps = -(acp_prev - acp_t) / denom
    return c_sample, c_eps


_AB = {
    1: (1.0,),
    2: (1.5, -0.5),
    3: (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    4: (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
}


def pndm_rows(
    schedule: NoiseSchedule,
    num_steps: int,
    *,
    prediction_type: str = "epsilon",
    tag: str = "",
) -> List[StepRow]:
    if prediction_type not in ("epsilon", "v_prediction"):
        raise NotImplementedError(
            f"PNDM/PLMS rows support epsilon and v_prediction, got {prediction_type!r}"
        )
    T = schedule.config.num_train_timesteps
    ratio = T // num_steps
    ts = plms_timesteps(num_steps, T, schedule.config.steps_offset)

    rows: List[StepRow] = []
    ets_len = 0
    for k, t in enumerate(int(x) for x in ts):
        if k == 1:
            # Redo the first transition (t0 -> t0 - ratio) from the saved
            # sample with the averaged epsilon (eps_current + hist[0]) / 2.
            t_used, prev_used = t + ratio, t
            push, use_saved, save_cur = False, True, False
            ab_eps, ab_hist = 0.5, (0.5,)
        else:
            t_used, prev_used = t, t - ratio
            push, use_saved = True, False
            save_cur = k == 0
            ets_len = min(ets_len + 1, 4)
            ab = _AB[ets_len]
            ab_eps, ab_hist = 0.0, ab  # hist[0] is the just-pushed current output
        c_sample, c_eps = _prev_sample_coeffs(schedule, t_used, prev_used)
        # diffusers' v-prediction semantics: the ring stores raw v outputs;
        # the v -> eps conversion applies once to the combined output, at the
        # (k == 1: shifted) t_used and the (k == 1: saved) base sample.
        if prediction_type == "v_prediction":
            acp_u = float(schedule.acp(t_used))
            e_s, e_e = float(np.sqrt(1.0 - acp_u)), float(np.sqrt(acp_u))
        else:
            e_s, e_e = 0.0, 1.0
        # x0 capture for introspection (PNDM itself never exposes it).
        acp_t = float(schedule.acp(t))
        if prediction_type == "v_prediction":
            cx = (float(np.sqrt(acp_t)), float(-np.sqrt(1.0 - acp_t)))
        else:
            cx = (float(1.0 / np.sqrt(acp_t)),
                  float(-np.sqrt(1.0 - acp_t) / np.sqrt(acp_t)))
        rows.append(
            StepRow(
                timestep=t,
                w_sample=float(c_sample + c_eps * e_s),
                w_eps=float(c_eps * e_e * ab_eps),
                w_hist=tuple(float(c_eps * e_e * a) for a in ab_hist),
                w_noise=0.0,
                cm_sample=0.0,
                cm_eps=1.0,  # the ring stores the raw model output (eps or v)
                cx_sample=cx[0],
                cx_eps=cx[1],
                push=push,
                use_saved=use_saved,
                save_cur=save_cur,
                scheduler="pndm",
                tag=tag,
            )
        )
    return rows
