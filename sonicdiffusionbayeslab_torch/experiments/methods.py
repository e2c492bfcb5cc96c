"""Experiment methods of the port (``methods_registry``).

Counterpart of ``sonicdiffusionbayeslab_tpu/experiments/methods.py``: the
reference's ``default`` (PNDM), ``ddim``, ``dpm_solver``, ``deep_cache``
(with Token Merging's ``tome_ratio``), ``consistency_model`` (LCM),
``two_schedulers``, ``interliving_schedulers`` and ``skip_steps``, and the
JAX package's ``unipc``, ``deis``, ``tome`` and ``flow_euler`` (SD3), with the JAX methods' grid
labels and call arguments.
A method is a scheduler assignment and a grid definition; generation and
validation live in ``BaseMethod``.
"""

from __future__ import annotations

from typing import Iterable

from sonicdiffusionbayeslab_torch.experiments.base import BaseMethod
from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
from sonicdiffusionbayeslab_torch.registry import methods_registry


def _sweep(v) -> list:
    """A sweep axis: a YAML list ([10, 20]) or a bare scalar (20)."""
    return list(v) if isinstance(v, (list, tuple)) else [v]


_MULTISTEP_SCHEDULERS = ("dpm_solver_scheduler", "deis_scheduler", "unipc_scheduler")


def _composer_scheduler_kwargs(name: str, params) -> dict:
    """Per-scheduler kwargs of the composing methods, which build their
    schedulers by registry name: multistep families take the sweep's
    ``solver_order``; the flow family takes the sigma-grid ``shift``."""
    if name in _MULTISTEP_SCHEDULERS:
        return {"solver_order": int(params.get("solver_order", 2))}
    if name == "flow_match_euler_scheduler":
        return {"shift": float(params.get("shift", 3.0))}
    return {}


def _steps_grid(params, default, use_x0=True) -> Iterable[dict]:
    for steps in _sweep(params.get("num_inference_steps", default)):
        yield {
            "label": f"steps_{steps}",
            "call_kw": {"num_inference_steps": int(steps), "use_x0": use_x0},
        }


@methods_registry.add_to_registry("default")
class DefaultStableDiffusion(BaseMethod):
    """Step sweep with SD-1.5's default PNDM (PLMS) scheduler."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler("pndm_scheduler")

    def grid(self) -> Iterable[dict]:
        return _steps_grid(self.params, [50])


@methods_registry.add_to_registry("ddim")
class DDIMMethod(BaseMethod):
    """DDIM step sweep (the config's ``scheduler_name``), x0 capture when
    ``use_x0``."""

    def grid(self) -> Iterable[dict]:
        return _steps_grid(self.params, [50], bool(self.params.get("use_x0", False)))


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
        return _steps_grid(self.params, [20])


@methods_registry.add_to_registry("unipc")
class UniPCMethod(BaseMethod):
    """UniPC step sweep, the same sweep as dpm_solver's."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "unipc_scheduler"),
            solver_order=int(self.params.get("solver_order", 2)),
            variant=self.params.get("variant", "bh2"),
            use_corrector=bool(self.params.get("use_corrector", True)),
            use_karras_sigmas=bool(self.params.get("use_karras_sigmas", False)),
        )

    def grid(self) -> Iterable[dict]:
        return _steps_grid(self.params, [20])


@methods_registry.add_to_registry("flow_euler")
class FlowEulerMethod(BaseMethod):
    """Rectified-flow Euler step sweep for the SD3 family (``shift``: the
    sigma grid's resolution shift, 3.0 = SD3-medium), the same sweep as
    dpm_solver's."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "flow_match_euler_scheduler"),
            shift=float(self.params.get("shift", 3.0)),
        )

    def grid(self) -> Iterable[dict]:
        return _steps_grid(self.params, [28])


@methods_registry.add_to_registry("deis")
class DEISMethod(BaseMethod):
    """DEIS-logrho step sweep, the same sweep as dpm_solver's."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "deis_scheduler"),
            solver_order=int(self.params.get("solver_order", 2)),
            final_sigmas_type=self.params.get("final_sigmas_type", "zero"),
            use_karras_sigmas=bool(self.params.get("use_karras_sigmas", False)),
        )

    def grid(self) -> Iterable[dict]:
        return _steps_grid(self.params, [20])


@methods_registry.add_to_registry("deep_cache")
class DeepCacheMethod(BaseMethod):
    """DeepCache sweep over (cache_interval x steps): each grid point's
    ``pre`` hook sets the pipeline's ``cache_plan_fn``, which the run
    clears at its end.  An optional ``tome_ratio`` adds Token Merging to
    every point."""

    def grid(self) -> Iterable[dict]:
        branch = int(self.params.get("cache_branch_id", 0))
        tome = self.params.get("tome_ratio")
        extra = {"tome_ratio": float(tome)} if tome is not None else {}
        for interval in _sweep(self.params.get("cache_interval", [2])):
            for steps in _sweep(self.params.get("num_inference_steps", [50])):
                yield {
                    "label": f"interval_{interval}_steps_{steps}",
                    "call_kw": {"num_inference_steps": int(steps), **extra},
                    "pre": lambda interval=interval: self._enable(int(interval), branch),
                }

    def _enable(self, interval: int, branch: int = 0) -> None:
        self.model.cache_plan_fn = lambda n: CachePlan.every(n, interval, branch)

    def run_experiment(self):
        orig_grid = self.grid

        def grid_with_hooks():
            for point in orig_grid():
                pre = point.pop("pre", None)
                if pre:
                    pre()
                yield point

        self.grid = grid_with_hooks  # type: ignore[assignment]
        try:
            return super().run_experiment()
        finally:
            self.grid = orig_grid  # type: ignore[assignment]
            self.model.cache_plan_fn = None


@methods_registry.add_to_registry("consistency_model")
class ConsistencyModelMethod(BaseMethod):
    """LCM sweep at guidance 0: the config's LoRA (``model.lora``, a local
    file) fused into the UNet, and the LCM scheduler."""

    def setup_model(self) -> None:
        super().setup_model()
        lora = self.config.model.get("lora", "latent-consistency/lcm-lora-sdv1-5")
        self.model.load_lora_weights(lora)
        self.model.fuse_lora()

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "lcm_scheduler")
        )

    def grid(self) -> Iterable[dict]:
        guidance = float(self.params.get("guidance_scale", 0.0))
        for steps in _sweep(self.params.get("num_inference_steps", [4])):
            yield {
                "label": f"steps_{steps}",
                "call_kw": {"num_inference_steps": int(steps), "guidance_scale": guidance},
            }


class _TwoSchedulerBase(BaseMethod):
    def _build_pair(self, key1: str, key2: str, default1: str, default2: str):
        scfg = self.config.get("scheduler")

        def build(name):
            return self.build_scheduler(name, **_composer_scheduler_kwargs(name, self.params))

        return (
            build(scfg.get(key1, default1) if scfg else default1),
            build(scfg.get(key2, default2) if scfg else default2),
        )


@methods_registry.add_to_registry("two_schedulers")
class TwoSchedulerMethod(_TwoSchedulerBase):
    """Scheduler-switch sweep over zipped (steps_first, steps_second,
    num_step_switch) triples."""

    def setup_scheduler(self) -> None:
        first, second = self._build_pair(
            "scheduler_first", "scheduler_second", "ddim_scheduler", "dpm_solver_scheduler"
        )
        self.model.scheduler_first = first
        self.model.scheduler_second = second

    def grid(self) -> Iterable[dict]:
        firsts = _sweep(self.params.get("num_inference_steps_first", [10]))
        seconds = _sweep(self.params.get("num_inference_steps_second", firsts))
        switches = _sweep(self.params.get("num_step_switch", [1]))
        type_switch = self.params.get("type_switch", "closest")
        for n1, n2, k in zip(firsts, seconds, switches):
            yield {
                "label": f"first_{n1}_second_{n2}_switch_{k}",
                "call_kw": {
                    "num_inference_steps": int(n1),
                    "num_inference_steps_second": int(n2),
                    "num_step_switch": int(k),
                    "type_switch": type_switch,
                },
            }


@methods_registry.add_to_registry("interliving_schedulers")
class InterlivingSchedulerMethod(_TwoSchedulerBase):
    """Interleaved-scheduler sweep over zipped (num_steps,
    interliving_steps) lists."""

    def setup_scheduler(self) -> None:
        main, inter = self._build_pair(
            "scheduler_main", "scheduler_inter", "dpm_solver_scheduler", "dpm_solver_scheduler"
        )
        self.model.scheduler_main = main
        self.model.scheduler_inter = inter

    def grid(self) -> Iterable[dict]:
        steps_list = _sweep(self.params.get("num_inference_steps", [20]))
        inter_lists = self.params.get("interliving_steps", [[0]])
        mode = self.params.get("interleave_mode", "ladder")
        for steps, inters in zip(steps_list, inter_lists):
            yield {
                "label": f"steps_{steps}_inter_{'-'.join(map(str, inters))}",
                "call_kw": {
                    "num_inference_steps": int(steps),
                    "interliving_steps": [int(i) for i in inters],
                    "interleave_mode": mode,
                },
            }


@methods_registry.add_to_registry("skip_steps")
class SkipStepsMethod(BaseMethod):
    """Step-skipping sweep over zipped (num_inference_steps, skip_steps)
    lists."""

    def setup_scheduler(self) -> None:
        name = (
            self.config.scheduler.get("scheduler_name", "dpm_solver_scheduler")
            if self.config.get("scheduler")
            else "dpm_solver_scheduler"
        )
        self.model.scheduler = self.build_scheduler(
            name, **_composer_scheduler_kwargs(name, self.params)
        )

    def grid(self) -> Iterable[dict]:
        steps_list = _sweep(self.params.get("num_inference_steps", [20]))
        skip_lists = self.params.get("skip_steps", [[]])
        for steps, skips in zip(steps_list, skip_lists):
            yield {
                "label": f"steps_{steps}_skip_{'-'.join(map(str, skips)) or 'none'}",
                "call_kw": {
                    "num_inference_steps": int(steps),
                    "skip_timesteps": [int(s) for s in skips],
                    "use_x0": True,
                },
            }


@methods_registry.add_to_registry("tome")
class TomeMethod(BaseMethod):
    """Token Merging sweep over (tome_ratio x steps) on the config's
    scheduler (DPM-Solver++ by default)."""

    def setup_scheduler(self) -> None:
        self.model.scheduler = self.build_scheduler(
            self.config.scheduler.get("scheduler_name", "dpm_solver_scheduler")
            if self.config.get("scheduler")
            else "dpm_solver_scheduler",
            solver_order=int(self.params.get("solver_order", 2)),
        )

    def grid(self) -> Iterable[dict]:
        for ratio in _sweep(self.params.get("tome_ratio", [0.5])):
            for steps in _sweep(self.params.get("num_inference_steps", [20])):
                yield {
                    "label": f"ratio_{ratio}_steps_{steps}",
                    "call_kw": {"num_inference_steps": int(steps), "tome_ratio": float(ratio),
                                "use_x0": True},
                }
