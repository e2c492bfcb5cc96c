"""The port's DDIM, PNDM and LCM plan builders and the plan composers
(two schedulers, interleave, skip steps) against the JAX package's: rows
bit-equal, the same raises, and the runtime over PNDM's saved buffer and
LCM's injected noise."""

from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from torch_parity import assert_close, randn, t
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.config import load_config
from sonicdiffusionbayeslab_torch.schedulers import runtime as R
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.schedulers import runtime as JR

REPO = Path(__file__).resolve().parents[1]


def assert_same_plan(got, want):
    assert got.name == want.name
    assert (got.nfe, got.hist_depth, got.needs_noise, got.has_saved) == (
        want.nfe, want.hist_depth, want.needs_noise, want.has_saved)
    g, w = got.scan_xs(), want.scan_xs()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


def _dpm(m, **kw):
    return m.DPMSolverScheduler(solver_order=kw.pop("solver_order", 2), **kw)


# Each case builds one plan with either package's module ``m``.
PLANS = {
    "ddim_20": lambda m: m.DDIMScheduler().build_plan(20),
    "ddim_eta0.5_10": lambda m: m.DDIMScheduler(eta=0.5).build_plan(10),
    "ddim_v_7": lambda m: m.DDIMScheduler(prediction_type="v_prediction").build_plan(7),
    "pndm_20": lambda m: m.PNDMScheduler().build_plan(20),
    "pndm_v_7": lambda m: m.PNDMScheduler(prediction_type="v_prediction").build_plan(7),
    **{f"lcm_{n}": (lambda m, n=n: m.LCMScheduler().build_plan(n)) for n in (1, 2, 4, 8)},
    **{f"two_ddim_dpm_{ts}": (lambda m, ts=ts: m.two_scheduler_plan(
        m.DDIMScheduler(), _dpm(m), 10, 10, 3, ts))
       for ts in ("closest", "left_closest", "right_closest")},
    **{f"two_dpm_ddim_{ts}": (lambda m, ts=ts: m.two_scheduler_plan(
        _dpm(m), m.DDIMScheduler(), 20, 20, 5, ts))
       for ts in ("closest", "left_closest", "right_closest")},
    "two_dpm3_dpm_30": lambda m: m.two_scheduler_plan(_dpm(m, solver_order=3), _dpm(m),
                                                      30, 30, 10),
    "interleave_dpm_dpm": lambda m: m.interleave_plan(_dpm(m), _dpm(m), 20, [2, 3]),
    "interleave_dpm_ddim": lambda m: m.interleave_plan(_dpm(m), m.DDIMScheduler(), 20, [0, 4]),
    "interleave_ddim_dpm": lambda m: m.interleave_plan(m.DDIMScheduler(), _dpm(m), 10, [3]),
    "interleave_ref_dpm_ddim": lambda m: m.interleave_plan(_dpm(m), m.DDIMScheduler(), 20,
                                                           [2, 3], mode="reference"),
    "interleave_ref_dpm3_ddim": lambda m: m.interleave_plan(
        _dpm(m, solver_order=3), m.DDIMScheduler(), 30, [1, 4], mode="reference"),
    "skip_dpm_5": lambda m: m.skip_plan(_dpm(m), 20, [5]),
    "skip_dpm_567": lambda m: m.skip_plan(_dpm(m), 20, [5, 6, 7]),
    "skip_dpm_0": lambda m: m.skip_plan(_dpm(m), 20, [0, 1]),
    "skip_ddim_5": lambda m: m.skip_plan(m.DDIMScheduler(), 20, [5]),
    "skip_ddim_eta": lambda m: m.skip_plan(m.DDIMScheduler(eta=0.3), 10, [0, 3, 9]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_rows_bit_equal_to_jax(case):
    assert_same_plan(PLANS[case](S), PLANS[case](JS))


def test_pndm_and_lcm_plan_shapes():
    """PNDM's 20 steps are 21 UNet evaluations over a 4-deep history with
    the saved buffer; LCM's 4 steps inject noise into all but the last."""
    pndm = S.PNDMScheduler().build_plan(20)
    assert (pndm.nfe, pndm.hist_depth, pndm.has_saved, pndm.needs_noise) == (21, 4, True, False)
    lcm = S.LCMScheduler().build_plan(4)
    assert (lcm.nfe, lcm.hist_depth, lcm.needs_noise) == (4, 1, True)
    assert list(lcm.w_noise != 0) == [True, True, True, False]


RAISES = {
    "interleave_ref_dpm_inter": lambda m: m.interleave_plan(_dpm(m), _dpm(m), 20, [2, 3],
                                                            mode="reference"),
    "interleave_ref_window0": lambda m: m.interleave_plan(_dpm(m), m.DDIMScheduler(), 20, [0],
                                                          mode="reference"),
    "interleave_ref_eta": lambda m: m.interleave_plan(_dpm(m), m.DDIMScheduler(eta=0.5), 20, [2],
                                                      mode="reference"),
    "interleave_ref_ddim_main": lambda m: m.interleave_plan(m.DDIMScheduler(), m.DDIMScheduler(),
                                                            20, [2], mode="reference"),
    "interleave_mode": lambda m: m.interleave_plan(_dpm(m), _dpm(m), 20, [2], mode="nope"),
    "interleave_lcm": lambda m: m.interleave_plan(_dpm(m), m.LCMScheduler(), 20, [2]),
    "two_switch_range": lambda m: m.two_scheduler_plan(m.DDIMScheduler(), _dpm(m), 10, 10, 11),
    "two_type_switch": lambda m: m.two_scheduler_plan(m.DDIMScheduler(), _dpm(m), 10, 10, 3,
                                                      "nearest"),
    "two_pndm_first": lambda m: m.two_scheduler_plan(m.PNDMScheduler(), _dpm(m), 10, 10, 3),
    "skip_everything": lambda m: m.skip_plan(_dpm(m), 3, [0, 1, 2]),
    "skip_lcm": lambda m: m.skip_plan(m.LCMScheduler(), 4, [1]),
    "pndm_tail": lambda m: m.PNDMScheduler().tail_plan(20, 3),
    "pndm_blend": lambda m: m.PNDMScheduler().blend_schedule(20),
    "pndm_sample_prediction": lambda m: m.PNDMScheduler(prediction_type="sample").build_plan(5),
    "lcm_too_many_steps": lambda m: m.LCMScheduler().build_plan(51),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_composers_raise_where_jax_raises(case):
    with pytest.raises(Exception) as want:
        RAISES[case](JS)
    with pytest.raises(want.type) as got:
        RAISES[case](S)
    assert str(got.value) == str(want.value)


def _config_points(m, name):
    """A thunk per sweep point of ``configs/<name>.yaml`` that builds its
    plan the way its method and pipeline do, with module ``m``."""
    cfg = load_config(REPO / "configs" / f"{name}.yaml")
    p, sched = cfg.experiment_params, cfg.get("scheduler") or {}
    order = int(p.get("solver_order", 2))

    def build(sname):
        return {"ddim_scheduler": lambda: m.DDIMScheduler(),
                "dpm_solver_scheduler": lambda: _dpm(m, solver_order=order),
                "lcm_scheduler": lambda: m.LCMScheduler()}[sname]()

    method = cfg.experiment.method
    if method == "default":
        return [lambda n=n: m.PNDMScheduler().build_plan(n) for n in p.num_inference_steps]
    if method in ("ddim", "deep_cache", "consistency_model"):
        return [lambda n=n: build(sched["scheduler_name"]).build_plan(n)
                for n in p.num_inference_steps]
    if method == "two_schedulers":
        return [lambda n1=n1, n2=n2, k=k: m.two_scheduler_plan(
                    build(sched["scheduler_first"]), build(sched["scheduler_second"]),
                    n1, n2, k, p.type_switch)
                for n1, n2, k in zip(p.num_inference_steps_first, p.num_inference_steps_second,
                                     p.num_step_switch)]
    if method == "interliving_schedulers":
        return [lambda n=n, w=w: m.interleave_plan(
                    build(sched["scheduler_main"]), build(sched["scheduler_inter"]), n, w)
                for n, w in zip(p.num_inference_steps, p.interliving_steps)]
    assert method == "skip_steps"
    return [lambda n=n, k=k: (m.skip_plan(build(sched["scheduler_name"]), n, k) if k
                              else build(sched["scheduler_name"]).build_plan(n))
            for n, k in zip(p.num_inference_steps, p.skip_steps)]


@pytest.mark.parametrize("name", [
    "default_stable_diffusion", "ddim_config", "deep_cache_config", "consistency_model_config",
    "two_schedulers_config", "interliving_schedulers_config", "skip_steps_config",
])
def test_shipped_config_sweep_plans_bit_equal_to_jax(name):
    """Every sweep point of the shipped config: the same rows, or the same
    error where the JAX builder refuses the point (PNDM at 1000 steps
    indexes past the schedule's end)."""
    got, want = _config_points(S, name), _config_points(JS, name)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        try:
            w_plan = w()
        except IndexError as e:
            with pytest.raises(IndexError, match=str(e)):
                g()
            continue
        assert_same_plan(g(), w_plan)


def _eps_pair(scale):
    return (lambda ts, lat: scale * lat + jnp.sin(ts / 100.0),
            lambda ts, lat: scale * lat + torch.sin(ts / 100.0))


def test_run_plan_pndm_matches_jax():
    """PNDM's duplicated first step reads the saved buffer and its later
    steps a 4-deep history: the runtime against the JAX package's."""
    plan, jplan = S.PNDMScheduler().build_plan(20), JS.PNDMScheduler().build_plan(20)
    x = randn((2, 8, 8, 4), 0)
    eps_jax, eps_torch = _eps_pair(0.3)
    want, want_x0 = JR.run_plan(jplan, jnp.asarray(x), eps_jax, collect_x0=True)
    got, got_x0 = R.run_plan(plan, t(x), eps_torch, collect_x0=True)
    assert_close(got, want, 1e-5, 1e-5)  # fp32 elementwise rows, as for DPM++
    assert_close(got_x0, want_x0, 1e-5, 1e-5)


def test_apply_row_with_noise_matches_jax():
    """LCM's rows with given noise: each step's update against the JAX
    runtime's on the same noise."""
    plan, jplan = S.LCMScheduler().build_plan(4), JS.LCMScheduler().build_plan(4)
    x = randn((2, 8, 8, 4), 1)
    noise = randn((4, 2, 8, 8, 4), 2)
    eps_jax, eps_torch = _eps_pair(0.2)
    carry, jcarry = R.init_carry(plan, t(x)), JR.init_carry(jplan, jnp.asarray(x))
    xs, jxs = R.plan_rows(plan, "cpu"), {k: jnp.asarray(v) for k, v in jplan.scan_xs().items()}
    for i in range(plan.num_steps):
        r, jr = R.row(xs, i), {k: v[i] for k, v in jxs.items()}
        carry, _ = R.apply_row(carry, eps_torch(r["timestep"], carry.latents), r, t(noise[i]))
        jcarry, _ = JR.apply_row(jcarry, eps_jax(jr["timestep"], jcarry.latents), jr,
                                 jnp.asarray(noise[i]))
    assert_close(carry.latents, jcarry.latents, 1e-5, 1e-5)
    with pytest.raises(ValueError, match="injects noise"):
        R.run_plan(plan, t(x), eps_torch)
