"""Noise schedule and timestep spacing (float64 numpy, plan time only).

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/schedule.py``
(the parts the DPM-Solver++, DDIM, PNDM and LCM plans reach).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Training-schedule constants (defaults = SD-1.5's scheduler config)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    trained_betas: Optional[Sequence[float]] = None
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    timestep_spacing: str = "leading"  # leading | linspace | trailing
    steps_offset: int = 1
    set_alpha_to_one: bool = False

    @classmethod
    def from_dict(cls, d) -> "ScheduleConfig":
        keep = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(d).items() if k in keep})


def make_betas(cfg: ScheduleConfig) -> np.ndarray:
    if cfg.trained_betas is not None:
        return np.asarray(cfg.trained_betas, dtype=np.float64)
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, T, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(T, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """alphas_cumprod table and derived helpers, all float64."""

    config: ScheduleConfig
    alphas_cumprod: np.ndarray  # [T]

    @classmethod
    def create(cls, cfg: ScheduleConfig) -> "NoiseSchedule":
        return cls(config=cfg, alphas_cumprod=np.cumprod(1.0 - make_betas(cfg)))

    def acp(self, t) -> np.ndarray:
        idx = np.asarray(t)
        if idx.dtype.kind == "f":
            r = np.round(idx)
            if not np.allclose(idx, r, atol=1e-3):
                raise ValueError(f"fractional timestep {t!r} has no alphas_cumprod entry")
            idx = r.astype(np.int64)
        return self.alphas_cumprod[idx]

    def acp_or_final(self, t) -> np.ndarray:
        """alphas_cumprod[t], with t < 0 mapping to the final (t=-1) value:
        1.0 if ``set_alpha_to_one`` else alphas_cumprod[0]."""
        t = np.asarray(t)
        final = 1.0 if self.config.set_alpha_to_one else self.alphas_cumprod[0]
        return np.where(t >= 0, self.alphas_cumprod[np.maximum(t, 0)], final)

    def alpha_sigma(self, t):
        """Data-space VP (alpha_t, sigma_t): alpha^2 + sigma^2 = 1."""
        a2 = self.acp(t)
        return np.sqrt(a2), np.sqrt(1.0 - a2)

    def kar_sigma(self, t) -> np.ndarray:
        """Karras-convention sigma = sigma_t / alpha_t."""
        a2 = self.acp(t)
        return np.sqrt((1.0 - a2) / a2)


def space_timesteps(
    num_steps: int, num_train_timesteps: int = 1000, spacing: str = "leading",
    steps_offset: int = 0,
) -> np.ndarray:
    """Descending int timesteps for a run, diffusers-compatible semantics."""
    T = num_train_timesteps
    if num_steps > T:
        raise ValueError(f"num_steps {num_steps} > num_train_timesteps {T}")
    if spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps).round()[::-1].astype(np.int64)
    elif spacing == "leading":
        ratio = T // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + steps_offset
    elif spacing == "trailing":
        ratio = T / num_steps
        ts = np.arange(T, 0, -ratio).round().astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing {spacing!r}")
    return ts.astype(np.int64)


def karras_sigmas(sigma_min: float, sigma_max: float, num_steps: int, rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 (EDM) sigma grid, descending, length ``num_steps``."""
    ramp = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    inv_min, inv_max = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    return (inv_max + ramp * (inv_min - inv_max)) ** rho


def sigma_to_t(schedule: NoiseSchedule, sigma) -> np.ndarray:
    """Fractional training timestep for a Karras sigma (log-sigma
    interpolation over the training table)."""
    table = np.sqrt((1.0 - schedule.alphas_cumprod) / schedule.alphas_cumprod)
    return np.interp(np.log(np.asarray(sigma, np.float64)), np.log(table),
                     np.arange(len(table), dtype=np.float64))


def x0_conversion_coeffs(schedule: NoiseSchedule, t: int, prediction_type: str):
    """(c_sample, c_eps) such that x0 = c_sample * sample + c_eps * model_output."""
    alpha, sigma = schedule.alpha_sigma(t)
    if prediction_type == "epsilon":
        return 1.0 / alpha, -sigma / alpha
    if prediction_type == "v_prediction":
        return alpha, -sigma
    if prediction_type == "sample":
        return 0.0, 1.0
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def eps_conversion_coeffs(schedule: NoiseSchedule, t: int, prediction_type: str):
    """(c_sample, c_eps) such that epsilon = c_sample * sample + c_eps * model_output."""
    alpha, sigma = schedule.alpha_sigma(t)
    if prediction_type == "epsilon":
        return 0.0, 1.0
    if prediction_type == "v_prediction":
        return sigma, alpha
    if prediction_type == "sample":
        return 1.0 / sigma, -alpha / sigma
    raise ValueError(f"unknown prediction_type {prediction_type!r}")
