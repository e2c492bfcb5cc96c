"""Scheduler plans: the port's own copy of the part of
``sonicdiffusionbayeslab_tpu/schedulers/__init__.py`` that the ported
methods reach.

A scheduler object holds schedule constants and solver options and emits a
:class:`SamplePlan`; there is no per-run mutable state.  The composers in
``plans.py`` build plans from two schedulers (or one with skips) through
the hooks ``transition_rows``, ``transition_rows_from_schedule``,
``ladder_rows`` and ``skip_rows``.  Each builder is registered in the
port's ``schedulers_registry`` under the JAX package's name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sonicdiffusionbayeslab_torch.registry import schedulers_registry
from sonicdiffusionbayeslab_torch.schedulers.ddim import ddim_rows, ddim_transition_row
from sonicdiffusionbayeslab_torch.schedulers.deis import deis_rows
from sonicdiffusionbayeslab_torch.schedulers.dpm import (
    dpm_rows,
    make_karras_ladder,
    make_ladder,
    simulate_orders,
)
from sonicdiffusionbayeslab_torch.schedulers.euler import euler_rows, euler_sigmas, heun_rows
from sonicdiffusionbayeslab_torch.schedulers.flow import (
    flow_euler_rows,
    flow_sigmas,
    flow_transition_row,
)
from sonicdiffusionbayeslab_torch.schedulers.lcm import lcm_rows
from sonicdiffusionbayeslab_torch.schedulers.plan import SamplePlan, StepRow, stack_rows
from sonicdiffusionbayeslab_torch.schedulers.plans import (
    interleave_plan,
    skip_plan,
    two_scheduler_plan,
)
from sonicdiffusionbayeslab_torch.schedulers.pndm import pndm_rows
from sonicdiffusionbayeslab_torch.schedulers.schedule import (
    NoiseSchedule,
    ScheduleConfig,
    karras_sigmas,
    sigma_to_t,
    space_timesteps,
)
from sonicdiffusionbayeslab_torch.schedulers.unipc import unipc_rows

__all__ = [
    "ScheduleConfig", "NoiseSchedule", "SamplePlan", "StepRow", "DDIMScheduler",
    "DEISScheduler", "DPMSolverScheduler", "EulerAncestralScheduler", "EulerScheduler",
    "FlowMatchEulerScheduler", "HeunScheduler", "LCMScheduler", "PNDMScheduler", "UniPCScheduler", "two_scheduler_plan",
    "interleave_plan", "skip_plan",
]


class _PlanBuilder:
    NAME = "base"
    # Sample space of the carried latent: the composers join only
    # schedulers of one space.
    SPACE = "vp"

    def __init__(self, schedule_config=None, prediction_type: Optional[str] = None):
        base = ScheduleConfig.from_dict(schedule_config or {})
        if prediction_type is not None:
            base = dataclasses.replace(base, prediction_type=prediction_type)
        self.schedule = NoiseSchedule.create(base)
        self.config = base

    @classmethod
    def from_config(cls, schedule_config, **kwargs):
        """The reference's ``from_config(pipe.scheduler.config, **kw)``
        construction, as the JAX package's parity shim."""
        return cls(schedule_config=schedule_config, **kwargs)

    def timesteps(self, num_steps: int) -> np.ndarray:
        return space_timesteps(
            num_steps, self.config.num_train_timesteps, self.config.timestep_spacing,
            self.config.steps_offset,
        )

    def build_plan(self, num_steps: int) -> SamplePlan:
        raise NotImplementedError

    # img2img hooks.
    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        """The rows of steps ``start_index..`` of an ``num_steps`` run
        (img2img's strength).  Here a slice of the whole plan, right for
        samplers whose rows keep no history (DDIM, LCM); the multistep
        builders re-simulate their warm-up from the start row, and the
        Euler family re-grids its sigmas."""
        if start_index == 0:
            return self.build_plan(num_steps)
        return self.build_plan(num_steps).tail(start_index)

    def noised_latents(self, z, noise, num_steps: int, start_index: int):
        """``tail_plan``'s initial latents: z noised to the start step's
        level in this sampler's space (VP: a_t z + s_t noise)."""
        t = int(self.timesteps(num_steps)[start_index])
        a, s = self.schedule.alpha_sigma(t)
        return float(a) * z + float(s) * noise

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        """(a [R], s [R]) float32, aligned with ``tail_plan``'s rows:
        inpainting's kept region after row k is ``a[k] z + s[k] noise``,
        the source re-noised to that row's output level; the last is the
        clean source (1, 0)."""
        ts = self.timesteps(num_steps)
        a, s = [], []
        for k in range(start_index, num_steps):
            ak, sk = self.schedule.alpha_sigma(int(ts[k + 1])) if k + 1 < num_steps else (1.0, 0.0)
            a.append(float(ak))
            s.append(float(sk))
        return np.asarray(a, np.float32), np.asarray(s, np.float32)

    # Composer hooks; overridden where supported.
    def transition_rows(self, ts, num_steps, executed, tag=""):
        raise NotImplementedError(f"{self.NAME} cannot be composed this way")

    def transition_rows_from_schedule(self, ts, start, tag=""):
        raise NotImplementedError(f"{self.NAME} cannot be composed this way")

    def ladder_rows(self, ts_exec, positions, tag=""):
        raise NotImplementedError(f"{self.NAME} cannot be interleaved")

    def skip_rows(self, num_steps, executed, tag=""):
        raise NotImplementedError(f"{self.NAME} does not support skip plans")


@schedulers_registry.add_to_registry("ddim_scheduler")
class DDIMScheduler(_PlanBuilder):
    NAME = "ddim"

    def __init__(self, schedule_config=None, prediction_type=None, eta: float = 0.0):
        super().__init__(schedule_config, prediction_type)
        self.eta = float(eta)

    def _row(self, t, prev_t, tag):
        return ddim_transition_row(self.schedule, int(t), int(prev_t), eta=self.eta,
                                   prediction_type=self.config.prediction_type, tag=tag)

    def build_plan(self, num_steps: int) -> SamplePlan:
        rows = self.transition_rows(self.timesteps(num_steps), num_steps, executed=None)
        return stack_rows(rows, name=f"ddim(n={num_steps})")

    def transition_rows(self, ts, num_steps, executed, tag=""):
        return ddim_rows(self.schedule, ts, num_steps, eta=self.eta,
                         prediction_type=self.config.prediction_type, executed=executed,
                         tag=tag)

    def transition_rows_from_schedule(self, ts, start, tag=""):
        # Seeded-schedule phase: transitions follow the given timestep list.
        return self.ladder_rows(ts, range(start, len(ts)), tag)

    def ladder_rows(self, ts_exec, positions, tag=""):
        return [self._row(ts_exec[p], ts_exec[p + 1] if p + 1 < len(ts_exec) else -1, tag)
                for p in positions]

    def skip_rows(self, num_steps, executed, tag=""):
        return self.transition_rows(self.timesteps(num_steps), num_steps, executed, tag)


class _MultistepLadderScheduler(_PlanBuilder):
    """Ladder-based multistep exponential integrators: Karras or spaced
    ladders, the order warm-up bookkeeping and the composer hooks.
    Subclasses set ``_rows``."""

    PLAN_PREFIX = "multistep"

    def __init__(
        self,
        schedule_config=None,
        prediction_type=None,
        solver_order: int = 2,
        final_sigmas_type: str = "zero",
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        use_karras_sigmas: bool = False,
    ):
        super().__init__(schedule_config, prediction_type)
        if solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order must be 1-3, got {solver_order}")
        self.solver_order = int(solver_order)
        self.final_sigmas_type = final_sigmas_type
        self.lower_order_final = bool(lower_order_final)
        self.euler_at_final = bool(euler_at_final)
        self.use_karras_sigmas = bool(use_karras_sigmas)

    @staticmethod
    def _rows(schedule, ladder, positions, **kw):
        raise NotImplementedError

    def _kw(self):
        return dict(
            solver_order=self.solver_order,
            final_sigmas_type=self.final_sigmas_type,
            prediction_type=self.config.prediction_type,
            lower_order_final=self.lower_order_final,
            euler_at_final=self.euler_at_final,
        )

    def _ladder(self, num_steps: int):
        if self.use_karras_sigmas:
            return make_karras_ladder(self.schedule, num_steps, self.final_sigmas_type)
        return make_ladder(self.schedule, self.timesteps(num_steps), self.final_sigmas_type)

    def build_plan(self, num_steps: int) -> SamplePlan:
        return self.tail_plan(num_steps, 0)

    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        """Steps ``start_index..`` of an ``num_steps`` run, re-simulated
        from an empty history (order warm-up)."""
        ladder = self._ladder(num_steps)
        rows = self._rows(self.schedule, ladder, range(start_index, num_steps), **self._kw())
        kar = "-karras" if self.use_karras_sigmas else ""
        sfx = f"[{start_index}:]" if start_index else ""
        return stack_rows(
            rows,
            name=f"{self.PLAN_PREFIX}{self.solver_order}{kar}(n={num_steps}){sfx}",
            hist_depth=self.solver_order,
        )

    def noised_latents(self, z, noise, num_steps: int, start_index: int):
        ladder = self._ladder(num_steps)
        return float(ladder.alpha[start_index]) * z + float(ladder.sigma_t[start_index]) * noise

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        ladder = self._ladder(num_steps)
        idx = np.arange(start_index + 1, num_steps + 1)
        return (np.asarray(ladder.alpha[idx], np.float32),
                np.asarray(ladder.sigma_t[idx], np.float32))

    def transition_rows(self, ts, num_steps, executed, tag=""):
        ladder = make_ladder(self.schedule, ts, self.final_sigmas_type)
        return self._rows(self.schedule, ladder, list(executed), tag=tag, **self._kw())

    def transition_rows_from_schedule(self, ts, start, tag=""):
        ladder = make_ladder(self.schedule, ts, self.final_sigmas_type)
        return self._rows(self.schedule, ladder, range(start, len(ts)), tag=tag, **self._kw())

    def ladder_rows(self, ts_exec, positions, tag=""):
        ladder = make_ladder(self.schedule, ts_exec, self.final_sigmas_type)
        # Every executed step pushes into the shared ring, so the k-th listed
        # position has at least k entries; the warm-up caps the order there.
        orders = simulate_orders(
            positions, len(ts_exec), self.solver_order,
            lower_order_final=self.lower_order_final, euler_at_final=self.euler_at_final,
            final_sigmas_type=self.final_sigmas_type,
        )
        return self._rows(self.schedule, ladder, positions, orders=orders, tag=tag, **self._kw())

    def skip_rows(self, num_steps, executed, tag=""):
        ts = self.timesteps(num_steps)
        ladder = make_ladder(self.schedule, ts, self.final_sigmas_type)
        positions = [executed[0] + k for k in range(len(executed))]
        unet_ts = [int(ts[i]) for i in executed]
        return self._rows(self.schedule, ladder, positions, unet_timesteps=unet_ts, tag=tag,
                          **self._kw())


@schedulers_registry.add_to_registry("dpm_solver_scheduler")
class DPMSolverScheduler(_MultistepLadderScheduler):
    NAME = "dpm_solver"
    PLAN_PREFIX = "dpm"

    def __init__(
        self,
        schedule_config=None,
        prediction_type=None,
        solver_order: int = 2,
        algorithm_type: str = "dpmsolver++",
        solver_type: str = "midpoint",
        final_sigmas_type: str = "zero",
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        use_karras_sigmas: bool = False,
    ):
        super().__init__(
            schedule_config, prediction_type,
            solver_order=solver_order, final_sigmas_type=final_sigmas_type,
            lower_order_final=lower_order_final, euler_at_final=euler_at_final,
            use_karras_sigmas=use_karras_sigmas,
        )
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type

    _rows = staticmethod(dpm_rows)

    def _kw(self):
        kw = super()._kw()
        kw.update(algorithm_type=self.algorithm_type, solver_type=self.solver_type)
        return kw


@schedulers_registry.add_to_registry("deis_scheduler")
class DEISScheduler(_MultistepLadderScheduler):
    """DEIS logrho multistep (``deis.py``): the multistep ladder body with
    DEIS's row expansion."""

    NAME = "deis"
    PLAN_PREFIX = "deis"

    _rows = staticmethod(deis_rows)


@schedulers_registry.add_to_registry("lcm_scheduler")
class LCMScheduler(_PlanBuilder):
    NAME = "lcm"

    def __init__(
        self,
        schedule_config=None,
        prediction_type=None,
        original_inference_steps: int = 50,
        timestep_scaling: float = 10.0,
        sigma_data: float = 0.5,
    ):
        super().__init__(schedule_config, prediction_type)
        self.original_inference_steps = int(original_inference_steps)
        self.timestep_scaling = float(timestep_scaling)
        self.sigma_data = float(sigma_data)

    def build_plan(self, num_steps: int) -> SamplePlan:
        rows = lcm_rows(
            self.schedule,
            num_steps,
            original_inference_steps=self.original_inference_steps,
            timestep_scaling=self.timestep_scaling,
            sigma_data=self.sigma_data,
            prediction_type=self.config.prediction_type,
        )
        return stack_rows(rows, name=f"lcm(n={num_steps})")


@schedulers_registry.add_to_registry("unipc_scheduler")
class UniPCScheduler(_PlanBuilder):
    """UniPC multistep predictor-corrector (``unipc.py``)."""

    NAME = "unipc"

    def __init__(
        self,
        schedule_config=None,
        prediction_type=None,
        solver_order: int = 2,
        variant: str = "bh2",
        use_corrector: bool = True,
        lower_order_final: bool = True,
        final_sigmas_type: str = "zero",
        use_karras_sigmas: bool = False,
    ):
        super().__init__(schedule_config, prediction_type)
        if solver_order < 1:
            raise ValueError(f"solver_order must be >= 1, got {solver_order}")
        self.solver_order = int(solver_order)
        self.variant = variant
        self.use_corrector = bool(use_corrector)
        self.lower_order_final = bool(lower_order_final)
        self.final_sigmas_type = final_sigmas_type
        self.use_karras_sigmas = bool(use_karras_sigmas)

    _ladder = _MultistepLadderScheduler._ladder
    noised_latents = _MultistepLadderScheduler.noised_latents
    blend_schedule = _MultistepLadderScheduler.blend_schedule

    def build_plan(self, num_steps: int) -> SamplePlan:
        return self.tail_plan(num_steps, 0)

    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        """Steps ``start_index..`` of an ``num_steps`` run, the orders
        ramping from 1 at the first executed step; the corrector reads one
        history slot more than the predictor."""
        rows = unipc_rows(
            self.schedule, self._ladder(num_steps), range(start_index, num_steps),
            solver_order=self.solver_order, variant=self.variant,
            use_corrector=self.use_corrector, lower_order_final=self.lower_order_final,
            prediction_type=self.config.prediction_type,
        )
        kar = "-karras" if self.use_karras_sigmas else ""
        sfx = f"[{start_index}:]" if start_index else ""
        return stack_rows(
            rows, name=f"unipc{self.solver_order}-{self.variant}{kar}(n={num_steps}){sfx}",
            hist_depth=self.solver_order + 1,
        )


@schedulers_registry.add_to_registry("euler_scheduler")
class EulerScheduler(_PlanBuilder):
    """Euler discrete in sigma space (``euler.py``): the composers refuse
    to join it to a VP scheduler."""

    NAME = "euler"
    ANCESTRAL = False
    SPACE = "sigma"

    def __init__(self, schedule_config=None, prediction_type=None,
                 use_karras_sigmas: bool = False):
        super().__init__(schedule_config, prediction_type)
        self.use_karras_sigmas = bool(use_karras_sigmas)

    def _grid(self, num_steps: int):
        """(timesteps, sigmas [num_steps + 1], init_noise_sigma) of the
        whole schedule."""
        if self.use_karras_sigmas:
            table = np.sqrt((1.0 - self.schedule.alphas_cumprod) / self.schedule.alphas_cumprod)
            sig = karras_sigmas(float(table[0]), float(table[-1]), num_steps)
            ts = sigma_to_t(self.schedule, sig)
            sigmas = np.concatenate([sig, [0.0]])
        else:
            ts = self.timesteps(num_steps)
            sigmas = euler_sigmas(self.schedule, ts)
        init = float(sigmas[0] if self.config.timestep_spacing in ("linspace", "trailing")
                     else np.sqrt(sigmas[0] ** 2 + 1.0))
        return ts, sigmas, init

    def _rows(self, ts, sigmas):
        return euler_rows(self.schedule, ts, ancestral=self.ANCESTRAL,
                          prediction_type=self.config.prediction_type, sigmas=sigmas)

    def build_plan(self, num_steps: int) -> SamplePlan:
        return self.tail_plan(num_steps, 0)

    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        """Rows of steps ``start_index..``; only a run from step 0 scales
        its initial latents by ``init_noise_sigma``."""
        ts, sigmas, init = self._grid(num_steps)
        kar = "-karras" if self.use_karras_sigmas else ""
        sfx = f"[{start_index}:]" if start_index else ""
        return stack_rows(self._rows(ts[start_index:], sigmas[start_index:]),
                          name=f"{self.NAME}{kar}(n={num_steps}){sfx}",
                          init_scale=init if start_index == 0 else 1.0)

    def noised_latents(self, z, noise, num_steps: int, start_index: int):
        """Sigma-space seeding: z + sigma_start * noise."""
        _, sigmas, _ = self._grid(num_steps)
        return z + float(sigmas[start_index]) * noise

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        _, sigmas, _ = self._grid(num_steps)
        s = np.asarray(sigmas[start_index + 1:], np.float32)
        return np.ones_like(s), s


@schedulers_registry.add_to_registry("euler_ancestral_scheduler")
class EulerAncestralScheduler(EulerScheduler):
    """Euler-ancestral: each row but the last injects fresh noise."""

    NAME = "euler_ancestral"
    ANCESTRAL = True


@schedulers_registry.add_to_registry("heun_scheduler")
class HeunScheduler(EulerScheduler):
    """Heun's second-order method: two UNet evaluations per transition but
    the last, so ``n`` steps are ``2n - 1`` rows."""

    NAME = "heun"

    def _rows(self, ts, sigmas):
        return heun_rows(self.schedule, ts, prediction_type=self.config.prediction_type,
                         sigmas=sigmas)

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        """A row each: both rows of a transition end at its target sigma;
        the last transition (to sigma 0) has one row."""
        _, sigmas, _ = self._grid(num_steps)
        s = []
        for k in range(start_index, num_steps):
            s2 = float(sigmas[k + 1])
            s.extend([s2] if s2 == 0.0 else [s2, s2])
        s = np.asarray(s, np.float32)
        return np.ones_like(s), s


@schedulers_registry.add_to_registry("flow_match_euler_scheduler")
class FlowMatchEulerScheduler(_PlanBuilder):
    """Rectified-flow Euler (``flow.py``), the sampler of SD3-class
    flow-matching transformers (``models/mmdit.py``): the carried sample
    lives on the path ``x = (1 - sigma) x0 + sigma eps`` and the model
    predicts velocity.  ``shift`` is the sigma grid's resolution shift (3.0
    is SD3-medium's).  Every composer hook is defined for flow-to-flow
    composition (memoryless rows on one sigma path); the composers' SPACE
    guard refuses a mix with a VP or sigma-space scheduler."""

    NAME = "flow_euler"
    SPACE = "flow"

    def __init__(self, schedule_config=None, prediction_type=None, shift: float = 3.0):
        cfg = dict(schedule_config or {})
        self.shift = float(cfg.pop("shift", shift))
        super().__init__(cfg, prediction_type)

    def _sigmas(self, num_steps: int) -> np.ndarray:
        return flow_sigmas(num_steps, shift=self.shift,
                           num_train_timesteps=self.config.num_train_timesteps)

    def timesteps(self, num_steps: int) -> np.ndarray:
        """sigma * T, descending floats (the grid without its trailing 0);
        the composers recover the sigmas exactly as ``t / T``."""
        return self._sigmas(num_steps)[:-1] * self.config.num_train_timesteps

    def _rows_on_grid(self, sigmas, indices, tag=""):
        sig = np.asarray(sigmas, np.float64)
        return [flow_transition_row(float(sig[i]), float(sig[i + 1]),
                                    num_train_timesteps=self.config.num_train_timesteps, tag=tag)
                for i in indices]

    @staticmethod
    def _grid_from_ts(ts, T) -> np.ndarray:
        """The sigma grid (trailing 0.0) of a composer's timestep array."""
        return np.concatenate([np.asarray(ts, np.float64) / T, [0.0]])

    def transition_rows(self, ts, num_steps, executed, tag=""):
        sig = self._grid_from_ts(ts, self.config.num_train_timesteps)
        return self._rows_on_grid(sig, list(executed), tag=tag)

    def transition_rows_from_schedule(self, ts, start, tag=""):
        sig = self._grid_from_ts(ts, self.config.num_train_timesteps)
        return self._rows_on_grid(sig, range(start, len(ts)), tag=tag)

    def ladder_rows(self, ts_exec, positions, tag=""):
        # Executed steps move along the executed schedule's noise levels.
        sig = self._grid_from_ts(ts_exec, self.config.num_train_timesteps)
        return self._rows_on_grid(sig, list(positions), tag=tag)

    def skip_rows(self, num_steps, executed, tag=""):
        # Memoryless rows: each executed step keeps its own sigma[i] ->
        # sigma[i + 1]; skipped transitions are absent, as DDIM's skips.
        return self._rows_on_grid(self._sigmas(num_steps), list(executed), tag=tag)

    def build_plan(self, num_steps: int) -> SamplePlan:
        return self.tail_plan(num_steps, 0)

    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        rows = flow_euler_rows(self._sigmas(num_steps)[start_index:],
                               num_train_timesteps=self.config.num_train_timesteps)
        sfx = f"[{start_index}:]" if start_index else ""
        return stack_rows(rows, name=f"{self.NAME}(n={num_steps},shift={self.shift:g}){sfx}")

    def noised_latents(self, z, noise, num_steps: int, start_index: int):
        """Flow-path seeding (img2img): (1 - sigma) z + sigma noise."""
        s = float(self._sigmas(num_steps)[start_index])
        return (1.0 - s) * z + s * noise

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        s = np.asarray(self._sigmas(num_steps)[start_index + 1:], np.float32)
        return (1.0 - s), s


@schedulers_registry.add_to_registry("pndm_scheduler")
class PNDMScheduler(_PlanBuilder):
    NAME = "pndm"

    def __init__(self, schedule_config=None, prediction_type=None):
        super().__init__(schedule_config, prediction_type)

    def build_plan(self, num_steps: int) -> SamplePlan:
        rows = pndm_rows(self.schedule, num_steps, prediction_type=self.config.prediction_type)
        return stack_rows(rows, name=f"pndm(n={num_steps})", hist_depth=4)

    def tail_plan(self, num_steps: int, start_index: int) -> SamplePlan:
        if start_index:
            raise NotImplementedError(
                "img2img tails are not defined for PLMS's duplicated warm-up step"
            )
        return self.build_plan(num_steps)

    def blend_schedule(self, num_steps: int, start_index: int = 0):
        raise NotImplementedError(
            "inpainting blend is not defined for PLMS's duplicated warm-up step"
        )
