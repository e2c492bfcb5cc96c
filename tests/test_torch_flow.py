"""The port's flow-matching Euler scheduler (``schedulers/flow.py``,
``FlowMatchEulerScheduler``) and the composers on it against the JAX
package (bit-equal rows, tails, seeding and blends; the two-scheduler, skip
and interleave flow plans; the SPACE guard), the ``flow_euler`` method,
and the three shipped SD3 configs through the port's CLI on the tiny
model."""

import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from test_torch_cli_methods import COMMON, _jax_points
from test_torch_schedulers import assert_same_plan
from torch_parity import randn
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.schedulers import flow as F
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.schedulers import flow as JF

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n,shift", [(1, 3.0), (4, 3.0), (28, 3.0), (20, 1.0), (14, 6.0)])
def test_flow_rows_bit_equal_to_jax(n, shift):
    """The sigma grid, its rows and the scheduler's plan, timesteps (float
    sigma * 1000) and every img2img tail."""
    np.testing.assert_array_equal(F.flow_sigmas(n, shift=shift), JF.flow_sigmas(n, shift=shift))
    sig = F.flow_sigmas(n, shift=shift)
    assert ([dataclasses.asdict(r) for r in F.flow_euler_rows(sig, tag="x")]
            == [dataclasses.asdict(r) for r in JF.flow_euler_rows(sig, tag="x")])
    got, want = S.FlowMatchEulerScheduler(shift=shift), JS.FlowMatchEulerScheduler(shift=shift)
    assert got.timesteps(n).tobytes() == want.timesteps(n).tobytes()
    assert_same_plan(got.build_plan(n), want.build_plan(n))
    for k in range(n):
        assert_same_plan(got.tail_plan(n, k), want.tail_plan(n, k))


@pytest.mark.parametrize("start", [0, 3, 7])
def test_flow_noised_latents_and_blend_bit_equal_to_jax(start):
    z, noise = randn((2, 4, 4, 16), 1), randn((2, 4, 4, 16), 2)
    got, want = S.FlowMatchEulerScheduler(shift=3.0), JS.FlowMatchEulerScheduler(shift=3.0)
    assert np.asarray(got.noised_latents(z, noise, 8, start)).tobytes() == np.asarray(
        want.noised_latents(z, noise, 8, start)).tobytes()
    for g, w in zip(got.blend_schedule(8, start), want.blend_schedule(8, start)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_flow_schedule_config_shift_and_registry():
    """``shift`` also comes in through the schedule config (the JAX
    builder pops it); the registry builds the scheduler by its JAX name."""
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, schedulers_registry

    load_all_plugins()
    got = S.FlowMatchEulerScheduler({"shift": 6.0})
    want = JS.FlowMatchEulerScheduler({"shift": 6.0})
    assert got.shift == want.shift == 6.0 and got.SPACE == "flow"
    assert_same_plan(got.build_plan(5), want.build_plan(5))
    sched = schedulers_registry["flow_match_euler_scheduler"](shift=3.0)
    assert isinstance(sched, S.FlowMatchEulerScheduler)


COMPOSED = {
    "switch_closest": lambda m: m.two_scheduler_plan(m.FlowMatchEulerScheduler(),
                                                     m.FlowMatchEulerScheduler(), 8, 8, 3),
    "switch_left": lambda m: m.two_scheduler_plan(m.FlowMatchEulerScheduler(shift=2.0),
                                                  m.FlowMatchEulerScheduler(), 10, 6, 4,
                                                  "left_closest"),
    "switch_right": lambda m: m.two_scheduler_plan(m.FlowMatchEulerScheduler(),
                                                   m.FlowMatchEulerScheduler(shift=5.0), 20, 20,
                                                   5, "right_closest"),
    "skip": lambda m: m.skip_plan(m.FlowMatchEulerScheduler(), 6, [2, 4]),
    "skip_28": lambda m: m.skip_plan(m.FlowMatchEulerScheduler(), 28, [7, 14, 21]),
    "interleave": lambda m: m.interleave_plan(m.FlowMatchEulerScheduler(),
                                              m.FlowMatchEulerScheduler(), 6, [1, 3]),
    "interleave_7": lambda m: m.interleave_plan(m.FlowMatchEulerScheduler(),
                                                m.FlowMatchEulerScheduler(shift=1.5), 7, [1]),
}


@pytest.mark.parametrize("case", sorted(COMPOSED))
def test_composed_flow_plans_bit_equal_to_jax(case):
    """Flow-to-flow switch (each join rule), skip and interleave (ladder)
    plans: the same rows as the JAX composers, float timesteps kept."""
    got, want = COMPOSED[case](S), COMPOSED[case](JS)
    assert_same_plan(got, want)
    assert not np.array_equal(got.timesteps, np.round(got.timesteps))


SPACE_MIXES = {
    "ddim_to_flow": lambda m: m.two_scheduler_plan(m.DDIMScheduler(), m.FlowMatchEulerScheduler(),
                                                   8, 8, 2),
    "flow_to_dpm": lambda m: m.two_scheduler_plan(m.FlowMatchEulerScheduler(),
                                                  m.DPMSolverScheduler(), 8, 8, 2),
    "dpm_inter_flow": lambda m: m.interleave_plan(m.DPMSolverScheduler(),
                                                  m.FlowMatchEulerScheduler(), 8, [1]),
    "euler_to_flow": lambda m: m.two_scheduler_plan(m.EulerScheduler(),
                                                    m.FlowMatchEulerScheduler(), 8, 8, 2),
}


@pytest.mark.parametrize("case", sorted(SPACE_MIXES))
def test_space_guard_refuses_flow_mixes_as_jax(case):
    with pytest.raises(ValueError) as want:
        SPACE_MIXES[case](JS)
    with pytest.raises(ValueError) as got:
        SPACE_MIXES[case](S)
    assert str(got.value) == str(want.value) and "space" in str(got.value)


@pytest.mark.parametrize("name", ["sd3_config", "sd3_skip_steps_config",
                                  "sd3_two_schedulers_config"])
def test_sd3_config_sweep_plans_bit_equal_to_jax(name):
    """Every sweep point of the shipped SD3 config, built as its method and
    pipeline build it in each package."""
    from sonicdiffusionbayeslab_torch.config import load_config

    p = load_config(REPO / "configs" / f"{name}.yaml").experiment_params
    for m in (S, JS):
        assert m.FlowMatchEulerScheduler(shift=p.shift).shift == 3.0
    if name == "sd3_config":
        pairs = [(lambda m, n=n: m.FlowMatchEulerScheduler(shift=p.shift).build_plan(n))
                 for n in p.num_inference_steps]
    elif name == "sd3_skip_steps_config":
        pairs = [(lambda m, n=n, k=k: m.skip_plan(m.FlowMatchEulerScheduler(shift=p.shift), n, k))
                 for n, k in zip(p.num_inference_steps, p.skip_steps)]
    else:
        pairs = [(lambda m, a=a, b=b, k=k: m.two_scheduler_plan(
                    m.FlowMatchEulerScheduler(shift=p.shift),
                    m.FlowMatchEulerScheduler(shift=p.shift), a, b, k, p.type_switch))
                 for a, b, k in zip(p.num_inference_steps_first, p.num_inference_steps_second,
                                    p.num_step_switch)]
    assert len(pairs) == 2
    for build in pairs:
        assert_same_plan(build(S), build(JS))


SD3_POINTS = {
    "sd3_config": {"experiment_params.num_inference_steps": [3]},
    "sd3_skip_steps_config": {"experiment_params.num_inference_steps": [5],
                              "experiment_params.skip_steps": [[1, 3]]},
    "sd3_two_schedulers_config": {"experiment_params.num_inference_steps_first": [4],
                                  "experiment_params.num_inference_steps_second": [4],
                                  "experiment_params.num_step_switch": [2]},
}


@pytest.mark.parametrize("name", sorted(SD3_POINTS))
def test_sd3_configs_through_the_cli(name, tmp_path, monkeypatch, capsys):
    """Each shipped SD3 config at tiny size (16-channel latents, 8x8, the
    MMDiT), one sweep point, its own method, pipeline, scheduler and
    ``unet_microbatch``: the JAX method's label and nfe, the table (CLIP
    score on the random tiny tower) and the PNGs."""
    config = str(REPO / "configs" / f"{name}.yaml")
    overrides = {**COMMON, **SD3_POINTS[name], "logger.run_id": "run"}
    want = _jax_points(config, overrides)
    monkeypatch.chdir(tmp_path)
    metrics = cli.run(config, overrides, device="cpu")
    assert "run dir: outputs/run" in capsys.readouterr().out
    with open(tmp_path / "outputs" / "run" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert [(r["exp"], int(r["nfe"])) for r in rows] == want
    assert metrics["exp"] == [want[0][0]] and np.isfinite(float(rows[0]["clip_score"]))
    assert len(list((tmp_path / "outputs").glob(f"*/{want[0][0]}/*.png"))) == 2
