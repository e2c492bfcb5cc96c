"""The CFG shared prefix, the NaN sanitizer and the attention-backend
selector of the port against the JAX package (tiny configs, fp32, CPU).

The prefix (``engine.sample(cfg_prefix=)``, else ``SDBL_CFG_PREFIX``)
runs the UNet's prefix once at B rows and tiles at the first
cross-attention: the same math as plain CFG.  Held to the JAX engine under
``SDBL_CFG_PREFIX=1`` with the same weights, initial latents and plan rows
within 2e-5 (``tests/test_models_sampler.py``'s gate between the JAX
engine's own prefix and plain runs), to the port's plain CFG within 1e-5,
and with ToMe 0.4 (the JAX UNet's destinations) within 2e-4 of both
(``tests/test_tome.py``'s gate).  Where the JAX package refuses it the
UNet raises the same words; where the JAX engine does not engage it the
port's UNet is called without it and gives the plain call's bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_tome_destinations, randn, t, tiny_engines,
                          tiny_family_engines)
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import CachePlan, StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.ops import attention as A
from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.ops import attention as JA
from sonicdiffusionbayeslab_tpu.ops import tome as JT

STEPS = 3


@pytest.fixture(scope="module")
def inputs():
    jeng, params, teng = tiny_engines()
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    return dict(lat0=randn((2, 8, 8, 4), 31),
                jax=(jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg_ids)),
                torch=(teng.encode_prompts(ids), teng.encode_prompts(neg_ids)))


def _jax_run(inputs, monkeypatch, prefix, tome=None):
    jeng, params, _ = tiny_engines()
    if prefix:
        monkeypatch.setenv("SDBL_CFG_PREFIX", "1")
    else:
        monkeypatch.delenv("SDBL_CFG_PREFIX", raising=False)
    return jeng.sample(params, JS.DPMSolverScheduler(solver_order=2).build_plan(STEPS),
                       *inputs["jax"], jax.random.PRNGKey(0), guidance_scale=7.5,
                       latent_hw=(8, 8), init_latents=jnp.asarray(inputs["lat0"]), tome=tome)


def _port_run(inputs, teng=None, **kw):
    teng = teng or tiny_engines()[2]
    return teng.sample(S.DPMSolverScheduler(solver_order=2).build_plan(STEPS), *inputs["torch"],
                       guidance_scale=7.5, latent_hw=(8, 8), init_latents=t(inputs["lat0"]), **kw)


class _Recorder:
    """Wraps an engine's ``denoise``: the batch and the ``cfg_shared_prefix``
    flag of each UNet call."""

    def __init__(self, eng):
        self.calls, self.inner = [], eng.denoise
        eng.denoise = self

    def __call__(self, sample, *args, **static):
        self.calls.append((sample.shape[0], static.get("cfg_shared_prefix", False)))
        return self.inner(sample, *args, **static)


def test_prefix_matches_jax_and_the_plain_call(inputs, monkeypatch):
    """The JAX engine under SDBL_CFG_PREFIX=1 and the port under the same
    variable (``cfg_prefix`` None): within 2e-5; the port's prefix within
    1e-5 of its plain CFG; every UNet call took the single copy."""
    want = _jax_run(inputs, monkeypatch, prefix=True)
    teng = tiny_engines()[2]
    rec = _Recorder(teng)
    try:
        got = _port_run(inputs, teng)
    finally:
        del teng.denoise
    assert rec.calls == [(2, True)] * STEPS
    plain = _port_run(inputs, cfg_prefix=False)
    assert_close(got.images, want.images, 2e-5)
    top = float(plain.latents.abs().max())
    assert_close(got.latents, want.latents, 2e-5 * top)
    assert_close(got.images, plain.images, 1e-5)
    assert_close(got.latents, plain.latents, 1e-5 * top)


def test_prefix_with_tome_matches_jax_and_tome_alone(inputs, monkeypatch):
    """ToMe 0.4 under the prefix: the first transformer's matching is built
    at B rows and its index maps serve the 2B blocks after it (the JAX
    closures tile theirs).  Against the JAX engine's prefix with ToMe and
    the port's ToMe without the prefix: 2e-4."""
    cfg = TomeConfig(0.4)
    want = _jax_run(inputs, monkeypatch, prefix=True,
                    tome=JT.TomeConfig(0.4, cfg.sx, cfg.sy, cfg.max_downsample, cfg.rand,
                                       cfg.metric_channels, cfg.share))
    teng = tiny_engines()[2]
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(STEPS)
    dst = t(jax_tome_destinations(plan.timesteps, teng.unet.tome_slots(8, 8, cfg)))
    got = _port_run(inputs, tome=cfg, tome_dst=dst, cfg_prefix=True)
    alone = _port_run(inputs, tome=cfg, tome_dst=dst, cfg_prefix=False)
    assert_close(got.images, want.images, 2e-4)
    assert_close(got.images, alone.images, 2e-4)


def test_prefix_unet_forward_is_the_plain_forward():
    """One UNet call: the single copy with the doubled context against the
    doubled copy, within 1e-5 of the output's largest magnitude; the output
    has the doubled batch."""
    teng = tiny_engines()[2]
    x, ctx = randn((2, 8, 8, 4), 32), randn((4, 77, 32), 33)
    ts = np.array([801.0, 801.0], np.float32)
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx), cfg_shared_prefix=True)
        want = teng.unet(t(np.concatenate([x, x])), t(np.concatenate([ts, ts])), t(ctx))
    assert got.shape == (4, 8, 8, 4)
    assert_close(got, want, 1e-5 * float(want.abs().max()))


REFUSED = {  # the JAX UNet's argument -> the port UNet's
    "added_cond": ("added_cond", "text_embeds"),
    "ip_context": ("ip_context", "ip_context"),
    "cache": ("cache", "cache"),
    "return_cache": ("return_cache", "return_cache"),
    "control_residuals": ("control_residuals", "control_residuals"),
    "timestep_cond": ("timestep_cond", "timestep_cond"),
    "context_batch": (None, None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unet_refuses_the_prefix_where_jax_does(case):
    """``cfg_shared_prefix`` with SDXL's conditioning, IP-Adapter, a
    DeepCache cache or ``return_cache``, ControlNet residuals or a
    ``timestep_cond``, or a context batch that is not twice the sample's:
    ValueError with the JAX UNet's words."""
    jeng, params, teng = tiny_engines()
    x, ts = randn((2, 8, 8, 4), 34), np.array([5.0, 5.0], np.float32)
    ctx = randn((2 if case == "context_batch" else 4, 77, 32), 35)
    zeros = np.zeros((2, 4), np.float32)
    jval = {"added_cond": {"text_embeds": zeros, "time_ids": zeros},
            "ip_context": randn((2, 4, 32), 36), "cache": randn((2, 8, 8, 64), 37),
            "return_cache": True, "control_residuals": ((), None),
            "timestep_cond": zeros}.get(case)
    jname, tname = REFUSED[case]
    with pytest.raises(ValueError) as jerr:
        jeng.unet.apply({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx), cfg_shared_prefix=True,
                        **({jname: jval} if jname else {}))
    tval = jval if tname in ("return_cache", "control_residuals") else (
        None if jval is None else t(jval if not isinstance(jval, dict) else zeros))
    with pytest.raises(ValueError) as err, torch.inference_mode():
        teng.unet(t(x), t(ts), t(ctx), cfg_shared_prefix=True,
                  **({tname: tval} if tname else {}))
    assert str(err.value) == str(jerr.value)


@functools.lru_cache(maxsize=None)
def _feature_engine(kind):
    """A tiny random port engine for one path the prefix does not engage
    on: with a ControlNet, an IP-Adapter, a w-conditioned UNet, or SDXL's."""
    if kind == "sdxl":
        return tiny_family_engines("sdxl")[2]
    cfg = UNetConfig.tiny()
    if kind == "timestep_cond":
        import dataclasses

        cfg = dataclasses.replace(cfg, time_cond_proj_dim=8)
    eng = StableDiffusionEngine(cfg, VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.float32, device="cpu").init_params(seed=1)
    if kind == "control":
        eng.init_controlnet(seed=2)
    if kind == "ip_adapter":
        eng.init_ip_adapter(seed=3, embed_dim=8)
    return eng


NOT_ENGAGED = {
    "no_cfg": dict(guidance_scale=1.0),
    "deep_cache": dict(cache_plan=CachePlan.every(STEPS, 2)),
    "microbatch_2": dict(microbatch=2),
    "control": dict(control={"image": np.full((2, 64, 64, 3), 0.5, np.float32)}),
    "ip_adapter": dict(ip_adapter={"image_embeds": np.ones((2, 8), np.float32)}),
    "timestep_cond": {},
    "sdxl": dict(added_cond={"text_embeds": np.ones((2, 16), np.float32),
                             "time_ids": np.tile([[64.0, 64.0, 0, 0, 64.0, 64.0]], (2, 1))}),
}


@pytest.mark.parametrize("case", sorted(NOT_ENGAGED))
def test_prefix_does_not_engage_where_jax_does_not(inputs, case):
    """CFG off, DeepCache, microbatch > 1, ControlNet, IP-Adapter, a
    w-conditioned UNet, SDXL's added conditioning: ``cfg_prefix=True`` is
    silently ignored (the JAX engine's rule): no UNet call gets it and
    the images are the plain call's bits."""
    kind = case if case in ("control", "ip_adapter", "timestep_cond", "sdxl") else None
    eng = _feature_engine(kind) if kind else tiny_engines()[2]
    kw = {"guidance_scale": 7.5, **NOT_ENGAGED[case]}
    if case != "sdxl":
        emb, neg = inputs["torch"]
    else:  # the tiny SDXL UNet's 32-wide context
        emb, neg = t(randn((2, 77, 32), 38)), t(randn((2, 77, 32), 39))
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(STEPS)
    args = (plan, emb, neg if kw["guidance_scale"] > 1 else None)
    kw.update(latent_hw=(8, 8), init_latents=t(inputs["lat0"]))
    rec = _Recorder(eng)
    try:
        got = eng.sample(*args, cfg_prefix=True, **kw)
    finally:
        del eng.denoise
    assert rec.calls and not any(flag for _, flag in rec.calls)
    want = eng.sample(*args, cfg_prefix=False, **kw)
    assert torch.equal(got.images, want.images)


NAN_PLAN = dict(algorithm_type="dpmsolver", final_sigmas_type="zero")


def test_sanitizer_raises_on_the_nan_plan_in_both_packages(inputs, monkeypatch):
    """``DPMSolverScheduler(algorithm_type="dpmsolver",
    final_sigmas_type="zero")`` gives NaN in its last row in both packages
    (ROADMAP.md section C): under SDBL_CHECK_NANS each raises
    FloatingPointError with the same words, after the loop; a finite run
    passes; ``check_nans=False`` beats the variable."""
    monkeypatch.setenv("SDBL_CHECK_NANS", "1")
    jeng, params, teng = tiny_engines()
    kw = dict(guidance_scale=7.5, latent_hw=(8, 8))
    with pytest.raises(FloatingPointError) as jerr:
        jeng.sample(params, JS.DPMSolverScheduler(**NAN_PLAN).build_plan(STEPS), *inputs["jax"],
                    jax.random.PRNGKey(0), init_latents=jnp.asarray(inputs["lat0"]), **kw)
    plan = S.DPMSolverScheduler(**NAN_PLAN).build_plan(STEPS)
    with pytest.raises(FloatingPointError) as err:
        teng.sample(plan, *inputs["torch"], init_latents=t(inputs["lat0"]), **kw)
    assert str(err.value) == str(jerr.value)
    assert "non-finite latents after plan" in str(err.value)
    out = teng.sample(plan, *inputs["torch"], init_latents=t(inputs["lat0"]), check_nans=False,
                      **kw)
    assert not bool(torch.isfinite(out.latents).all())
    _port_run(inputs)  # finite: passes the check


def test_attention_backend_selector_takes_the_jax_names(monkeypatch):
    """``set_attention_backend`` takes None, xla, pallas and tiered and
    refuses any other name with the JAX words; ``xla`` (explicit or from
    SDBL_ATTENTION) sends calls to the plain path, the rest to the kernels'
    rule; an explicit name beats the variable; whether the plain path is
    resolved is a part of the engine's graph state, so a toggle captures
    anew, while pallas, tiered and None share one graph."""
    teng = tiny_engines()[2]
    with pytest.raises(ValueError) as jerr:
        JA.set_attention_backend("flash")
    with pytest.raises(ValueError) as err:
        A.set_attention_backend("flash")
    assert str(err.value) == str(jerr.value)
    try:
        for name in ("xla", "pallas", "tiered", None):
            A.set_attention_backend(name)
            assert A.get_attention_backend() == name
            assert A.plain_selected() == (name == "xla")
            assert teng._graph_state() == ((("attention", "xla"),) if name == "xla" else ())
        monkeypatch.setenv("SDBL_ATTENTION", " XLA ")
        assert A.get_attention_backend() == "xla" and not A.plain_selected()  # not yet resolved
        assert A.resolve_attention_backend() and A.plain_selected()
        A.set_attention_backend("tiered")
        assert not A.plain_selected()
        calls = []
        monkeypatch.setattr(A, "flash_attention", lambda q, k, v: calls.append(1) or q)
        q = torch.ones(1, 4, 1, 8)
        A.dot_product_attention(q, q, q)
        A.set_attention_backend("xla")
        A.dot_product_attention(q, q, q)
        assert calls == [1]
    finally:
        monkeypatch.delenv("SDBL_ATTENTION", raising=False)
        A.set_attention_backend(None)


@pytest.mark.parametrize("value", ["flash", "cuda", "xla2"])
def test_unknown_sdbl_attention_raises_at_the_entry_point(inputs, monkeypatch, value):
    """An unknown ``SDBL_ATTENTION`` is refused where it is read (an
    engine's ``sample``, ``resolve_attention_backend``), never taken as a
    request for the plain path; the kernels' route stays as it was."""
    A.set_attention_backend(None)
    monkeypatch.setenv("SDBL_ATTENTION", value)
    try:
        with pytest.raises(ValueError, match=f"unknown SDBL_ATTENTION '{value}'"):
            A.resolve_attention_backend()
        with pytest.raises(ValueError, match="unknown SDBL_ATTENTION"):
            _port_run(inputs)
        assert not A.plain_selected()
    finally:
        monkeypatch.delenv("SDBL_ATTENTION", raising=False)
        A.resolve_attention_backend()
