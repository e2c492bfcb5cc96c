"""Scheduler plans: the port's own copy of the part of
``sonicdiffusionbayeslab_tpu/schedulers/__init__.py`` that
``DPMSolverScheduler(...).build_plan(n)`` reaches.

A scheduler object holds schedule constants and solver options and emits a
:class:`SamplePlan`; there is no per-run mutable state.  ``DPMSolverScheduler``
is registered as ``dpm_solver_scheduler`` in the port's
``schedulers_registry``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sonicdiffusionbayeslab_torch.registry import schedulers_registry
from sonicdiffusionbayeslab_torch.schedulers.dpm import dpm_rows, make_karras_ladder, make_ladder
from sonicdiffusionbayeslab_torch.schedulers.plan import SamplePlan, StepRow, stack_rows
from sonicdiffusionbayeslab_torch.schedulers.schedule import (
    NoiseSchedule,
    ScheduleConfig,
    space_timesteps,
)

__all__ = ["ScheduleConfig", "NoiseSchedule", "SamplePlan", "StepRow", "DPMSolverScheduler"]


class _PlanBuilder:
    NAME = "base"

    def __init__(self, schedule_config=None, prediction_type: Optional[str] = None):
        base = ScheduleConfig.from_dict(schedule_config or {})
        if prediction_type is not None:
            base = dataclasses.replace(base, prediction_type=prediction_type)
        self.schedule = NoiseSchedule.create(base)
        self.config = base

    def timesteps(self, num_steps: int) -> np.ndarray:
        return space_timesteps(
            num_steps, self.config.num_train_timesteps, self.config.timestep_spacing,
            self.config.steps_offset,
        )

    def build_plan(self, num_steps: int) -> SamplePlan:
        raise NotImplementedError


class _MultistepLadderScheduler(_PlanBuilder):
    """Ladder-based multistep exponential integrators: Karras or spaced
    ladders and the order warm-up bookkeeping.  Subclasses set ``_rows``."""

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
