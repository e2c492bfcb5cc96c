"""The port's DEIS, UniPC, Euler, Euler-ancestral and Heun plan builders
and rescaled CFG against the JAX package: plan rows bit-equal (the step
counts of configs/unipc_config.yaml and 20, orders 1-3, Karras sigmas on
and off, tails), the composers' refusal to join a sigma-space plan to a VP
one, and tiny fp32 engine runs of each (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import assert_close, jax_step_noise, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

STEP_COUNTS = (1, 2, 3, 4, 5, 10, 20, 50)


def assert_same_plan(got, want):
    assert got.name == want.name
    assert (got.nfe, got.hist_depth, got.needs_noise, got.has_saved, got.init_scale) == (
        want.nfe, want.hist_depth, want.needs_noise, want.has_saved, want.init_scale)
    g, w = got.scan_xs(), want.scan_xs()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("karras", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("family", ["UniPCScheduler", "DEISScheduler"])
def test_multistep_rows_bit_equal_to_jax(family, order, karras):
    for n in STEP_COUNTS:
        kw = dict(solver_order=order, use_karras_sigmas=karras)
        assert_same_plan(getattr(S, family)(**kw).build_plan(n),
                         getattr(JS, family)(**kw).build_plan(n))


@pytest.mark.parametrize("karras", [False, True])
@pytest.mark.parametrize("family", ["EulerScheduler", "EulerAncestralScheduler", "HeunScheduler"])
def test_sigma_space_rows_bit_equal_to_jax(family, karras):
    for n in STEP_COUNTS:
        assert_same_plan(getattr(S, family)(use_karras_sigmas=karras).build_plan(n),
                         getattr(JS, family)(use_karras_sigmas=karras).build_plan(n))


# Each case builds one plan with either package's module ``m``.
VARIANTS = {
    "unipc_bh1": lambda m: m.UniPCScheduler(variant="bh1").build_plan(10),
    "unipc_no_corrector": lambda m: m.UniPCScheduler(use_corrector=False).build_plan(10),
    "unipc_v": lambda m: m.UniPCScheduler(prediction_type="v_prediction").build_plan(7),
    "unipc_sample": lambda m: m.UniPCScheduler(prediction_type="sample").build_plan(7),
    "deis_v": lambda m: m.DEISScheduler(prediction_type="v_prediction").build_plan(7),
    "deis_sigma_min": lambda m: m.DEISScheduler(final_sigmas_type="sigma_min").build_plan(10),
    "euler_v": lambda m: m.EulerScheduler(prediction_type="v_prediction").build_plan(7),
    "heun_v": lambda m: m.HeunScheduler(prediction_type="v_prediction").build_plan(7),
    "euler_trailing": lambda m: m.EulerScheduler(
        {"timestep_spacing": "trailing"}).build_plan(10),
    **{f"{name}_tail_{start}": (lambda m, c=cls, s=start: getattr(m, c)().tail_plan(20, s))
       for name, cls in (("unipc", "UniPCScheduler"), ("deis", "DEISScheduler"),
                         ("euler", "EulerScheduler"), ("euler_a", "EulerAncestralScheduler"),
                         ("heun", "HeunScheduler"))
       for start in (0, 6, 19)},
    "unipc3_karras_tail": lambda m: m.UniPCScheduler(solver_order=3, use_karras_sigmas=True
                                                     ).tail_plan(10, 4),
    "two_deis_dpm": lambda m: m.two_scheduler_plan(m.DEISScheduler(),
                                                   m.DPMSolverScheduler(), 10, 10, 3),
    "interleave_dpm_deis": lambda m: m.interleave_plan(m.DPMSolverScheduler(),
                                                       m.DEISScheduler(), 20, [2, 3]),
    "skip_deis": lambda m: m.skip_plan(m.DEISScheduler(), 20, [5]),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_rows_bit_equal_to_jax(case):
    assert_same_plan(VARIANTS[case](S), VARIANTS[case](JS))


def test_plan_shapes():
    """Heun's n steps are 2n - 1 UNet evaluations over the saved buffer;
    UniPC's corrector reads one history slot past its order; Euler scales
    its initial latents by init_noise_sigma and each row's input by
    1/sqrt(sigma^2 + 1); Euler-ancestral injects noise in all rows but the
    last."""
    heun = S.HeunScheduler().build_plan(10)
    assert (heun.nfe, heun.has_saved, heun.needs_noise) == (19, True, False)
    for order in (1, 2, 3):
        unipc = S.UniPCScheduler(solver_order=order).build_plan(20)
        assert (unipc.nfe, unipc.hist_depth, unipc.has_saved) == (20, order + 1, True)
    euler = S.EulerScheduler().build_plan(20)
    init = 1.0 / np.sqrt(S.EulerScheduler().schedule.alphas_cumprod[951])  # sqrt(sigma^2 + 1)
    assert euler.init_scale == pytest.approx(init) and np.all(euler.in_scale < 1.0)
    assert S.EulerScheduler().tail_plan(20, 5).init_scale == 1.0
    anc = S.EulerAncestralScheduler().build_plan(5)
    assert list(anc.w_noise != 0) == [True, True, True, True, False]


COMPOSE = {  # name: (composition of Euler and DDIM, the refusal)
    "two_euler_ddim": (lambda m, e, d: m.two_scheduler_plan(e, d, 10, 10, 3),
                       ValueError, "sigma-space"),
    "two_ddim_euler": (lambda m, e, d: m.two_scheduler_plan(d, e, 10, 10, 3),
                       ValueError, "sigma-space"),
    "interleave_ddim_euler": (lambda m, e, d: m.interleave_plan(d, e, 10, [2]),
                              ValueError, "sigma-space"),
    "interleave_euler_ddim": (lambda m, e, d: m.interleave_plan(e, d, 10, [2]),
                              ValueError, "sigma-space"),
    "interleave_reference": (lambda m, e, d: m.interleave_plan(e, d, 10, [2], mode="reference"),
                             NotImplementedError, "DPM-family main"),
    "skip_euler": (lambda m, e, d: m.skip_plan(e, 10, [3]), NotImplementedError, "skip"),
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_composers_refuse_sigma_space_with_vp(case):
    """Euler carries x0 + sigma * eps, DDIM a_t x0 + s_t eps: neither
    package joins them, and neither skips Euler's steps."""
    compose, exc, match = COMPOSE[case]
    for m in (S, JS):
        with pytest.raises(exc, match=match):
            compose(m, m.EulerScheduler(), m.DDIMScheduler())


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engines():
    return tiny_engines()


@pytest.fixture(scope="module")
def inputs(engines):
    jeng, params, teng = engines
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    return dict(lat0=randn((2, 8, 8, 4), 7),
                jax=(jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg_ids)),
                torch=(teng.encode_prompts(ids), teng.encode_prompts(neg_ids)))


ENGINE_RUNS = {  # name: (plan builder on either package, steps, engine kwargs)
    "unipc": (lambda m: m.UniPCScheduler(), 5, {}),
    "deis": (lambda m: m.DEISScheduler(), 5, {}),
    "euler": (lambda m: m.EulerScheduler(), 5, {}),
    "euler_ancestral": (lambda m: m.EulerAncestralScheduler(), 5, {}),
    "heun": (lambda m: m.HeunScheduler(), 3, {}),
    "dpm_guidance_rescale": (lambda m: m.DPMSolverScheduler(), 5, {"guidance_rescale": 0.7}),
}


@pytest.mark.parametrize("name", sorted(ENGINE_RUNS))
def test_engine_matches_jax(engines, inputs, name):
    """A CFG-7.5 run of each sampler; Euler-ancestral with the JAX engine's
    own step noise passed in."""
    jeng, params, teng = engines
    builder, steps, kw = ENGINE_RUNS[name]
    jplan, plan = builder(JS).build_plan(steps), builder(S).build_plan(steps)
    key, idx = jax.random.PRNGKey(2), [0, 1]
    want = jeng.sample(params, jplan, *inputs["jax"], key, guidance_scale=7.5,
                       latent_hw=(8, 8), init_latents=jnp.asarray(inputs["lat0"]),
                       collect_x0=True, x0_samples=1, **kw)
    if plan.needs_noise:
        kw = dict(kw, step_noise=t(jax_step_noise(key, idx, plan.num_steps, (8, 8, 4))))
    got = teng.sample(plan, *inputs["torch"], guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=t(inputs["lat0"]), collect_x0=True, x0_samples=1, **kw)
    # fp32 over a few CFG-amplified steps (Euler's latents are scaled by
    # init_noise_sigma ~ 14.6), as the DPM++ engine test.
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)
    assert_close(got.x0_images, want.x0_images, 1e-3)
    assert got.nfe == want.nfe == plan.num_steps
