"""SamplePlan: per-step scheduler coefficients (host-side numpy).

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/plan.py``
(the parts the plan builders reach).  Every supported update is
linear in (sample, model output, history entries, fresh noise), so a run is
a stack of scalar coefficient rows, computed in float64 and stored as
float32.  ``schedulers/runtime.py`` applies one row per denoising step:

    eps   = model(in_scale * x, timestep)
    m     = cm_sample * x + cm_eps * eps       # converted model output
    x0    = cx_sample * x + cx_eps * eps       # x0 prediction
    hist  = push ? shift_in(hist, m) : hist    # hist[0] = most recent
    x'    = w_sample * x + w_saved * saved + w_eps * eps
            + sum_k w_hist[k] * hist[k] + w_noise * noise
    saved = s_x * x + s_saved * saved + sum_k s_hist[k] * hist[k]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StepRow:
    """One denoising step's coefficients (float64)."""

    timestep: float
    in_scale: float = 1.0
    w_sample: float = 0.0
    w_eps: float = 0.0
    w_hist: tuple = ()  # per-slot weights, slot 0 = most recent
    w_noise: float = 0.0
    cm_sample: float = 0.0
    cm_eps: float = 1.0
    cx_sample: float = 0.0
    cx_eps: float = 1.0
    push: bool = True
    use_saved: bool = False  # x' base = saved instead of x
    save_cur: bool = False  # saved' = x
    # General saved-buffer weights (override the Boolean flags when set).
    w_saved: Optional[float] = None
    s_x: Optional[float] = None
    s_saved: Optional[float] = None
    s_hist: tuple = ()
    scheduler: str = ""
    tag: str = ""

    def resolved_saved_weights(self):
        """(wx, w_saved, s_x, s_saved, s_hist) with the Boolean flags resolved."""
        explicit = any(v is not None for v in (self.w_saved, self.s_x, self.s_saved)) or self.s_hist
        if explicit:
            if self.use_saved or self.save_cur:
                raise ValueError("mix of Boolean saved flags and explicit saved weights")
            return (
                self.w_sample,
                self.w_saved or 0.0,
                self.s_x or 0.0,
                1.0 if self.s_saved is None else self.s_saved,
                tuple(self.s_hist),
            )
        wx, wsv = (0.0, self.w_sample) if self.use_saved else (self.w_sample, 0.0)
        sx, ssv = (1.0, 0.0) if self.save_cur else (0.0, 1.0)
        return wx, wsv, sx, ssv, ()


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Stacked per-step float32 arrays, shape [L] except ``w_hist`` and
    ``s_hist`` [L, H]."""

    name: str
    timesteps: np.ndarray
    in_scale: np.ndarray
    init_scale: float
    w_sample: np.ndarray
    w_eps: np.ndarray
    w_hist: np.ndarray
    w_noise: np.ndarray
    cm_sample: np.ndarray
    cm_eps: np.ndarray
    cx_sample: np.ndarray
    cx_eps: np.ndarray
    push: np.ndarray
    w_saved: np.ndarray
    s_x: np.ndarray
    s_saved: np.ndarray
    s_hist: np.ndarray
    rows: tuple = dataclasses.field(default=(), repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @property
    def nfe(self) -> int:
        """UNet evaluations: one per step."""
        return self.num_steps

    @property
    def hist_depth(self) -> int:
        return int(self.w_hist.shape[1])

    @property
    def needs_noise(self) -> bool:
        return bool(np.any(self.w_noise != 0.0))

    @property
    def has_saved(self) -> bool:
        return bool(
            np.any(self.w_saved != 0.0) or np.any(self.s_x != 0.0) or np.any(self.s_hist != 0.0)
        )

    def tail(self, start_index: int) -> "SamplePlan":
        """The plan of rows ``start_index..`` (img2img's start).
        ``init_scale`` is 1: the caller's latents are already noised to the
        start row's level (the schedulers' ``noised_latents``)."""
        if not self.rows:
            raise ValueError("plan has no retained rows to slice")
        if not 0 <= start_index < len(self.rows):
            raise ValueError(f"start_index {start_index} out of range [0, {len(self.rows)})")
        return stack_rows(list(self.rows[start_index:]), name=f"{self.name}[{start_index}:]",
                          hist_depth=self.hist_depth, init_scale=1.0)

    def scan_xs(self) -> Dict[str, np.ndarray]:
        """The per-step arrays the runtime walks through."""
        return {
            "timestep": self.timesteps,
            "in_scale": self.in_scale,
            "w_sample": self.w_sample,
            "w_eps": self.w_eps,
            "w_hist": self.w_hist,
            "w_noise": self.w_noise,
            "cm_sample": self.cm_sample,
            "cm_eps": self.cm_eps,
            "cx_sample": self.cx_sample,
            "cx_eps": self.cx_eps,
            "push": self.push,
            "w_saved": self.w_saved,
            "s_x": self.s_x,
            "s_saved": self.s_saved,
            "s_hist": self.s_hist,
        }


def stack_rows(
    rows: List[StepRow], name: str, hist_depth: Optional[int] = None, init_scale: float = 1.0,
) -> SamplePlan:
    if not rows:
        raise ValueError("empty plan")
    depth = hist_depth if hist_depth is not None else max(
        (max(len(r.w_hist), len(r.s_hist)) for r in rows), default=0
    )
    depth = max(depth, 1)
    L = len(rows)
    w_hist = np.zeros((L, depth), dtype=np.float32)
    s_hist = np.zeros((L, depth), dtype=np.float32)
    saved_w = np.zeros((L, 4), dtype=np.float32)  # wx, w_saved, s_x, s_saved
    for i, r in enumerate(rows):
        if max(len(r.w_hist), len(r.s_hist)) > depth:
            raise ValueError(f"row {i} uses more hist slots than depth {depth}")
        w_hist[i, : len(r.w_hist)] = np.asarray(r.w_hist, dtype=np.float32)
        wx, wsv, sx, ssv, sh = r.resolved_saved_weights()
        saved_w[i] = (wx, wsv, sx, ssv)
        s_hist[i, : len(sh)] = np.asarray(sh, dtype=np.float32)

    def f(field):
        return np.asarray([getattr(r, field) for r in rows], dtype=np.float32)

    return SamplePlan(
        name=name,
        timesteps=np.asarray([r.timestep for r in rows], dtype=np.float32),
        in_scale=f("in_scale"),
        init_scale=float(init_scale),
        w_sample=saved_w[:, 0],
        w_eps=f("w_eps"),
        w_hist=w_hist,
        w_noise=f("w_noise"),
        cm_sample=f("cm_sample"),
        cm_eps=f("cm_eps"),
        cx_sample=f("cx_sample"),
        cx_eps=f("cx_eps"),
        push=f("push"),
        w_saved=saved_w[:, 1],
        s_x=saved_w[:, 2],
        s_saved=saved_w[:, 3],
        s_hist=s_hist,
        rows=tuple(rows),
    )
