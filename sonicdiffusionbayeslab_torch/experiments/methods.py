"""Experiment methods of the port (``methods_registry``).

Counterpart of ``sonicdiffusionbayeslab_tpu/experiments/methods.py``; the
port has the ``dpm_solver`` method so far.  A method is a scheduler
assignment and a grid definition; generation and validation live in
``BaseMethod``.
"""

from __future__ import annotations

from typing import Iterable

from sonicdiffusionbayeslab_torch.experiments.base import BaseMethod
from sonicdiffusionbayeslab_torch.registry import methods_registry


def _sweep(v) -> list:
    """A sweep axis: a YAML list ([10, 20]) or a bare scalar (20)."""
    return list(v) if isinstance(v, (list, tuple)) else [v]


@methods_registry.add_to_registry("dpm_solver")
class DPMSolverMethod(BaseMethod):
    """DPM-Solver++ step sweep; scheduler kwargs come from experiment_params,
    with defaults for the keys a config leaves out."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "dpm_solver_scheduler"),
            solver_order=int(self.params.get("solver_order", 2)),
            algorithm_type=self.params.get("algorithm_type", "dpmsolver++"),
            final_sigmas_type=self.params.get("final_sigmas_type", "zero"),
            use_karras_sigmas=bool(self.params.get("use_karras_sigmas", False)),
        )

    def grid(self) -> Iterable[dict]:
        for steps in _sweep(self.params.get("num_inference_steps", [20])):
            yield {
                "label": f"steps_{steps}",
                "call_kw": {"num_inference_steps": int(steps), "use_x0": True},
            }
