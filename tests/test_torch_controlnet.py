"""ControlNet (``models/controlnet.py``, ``stable_diffusion_controlnet_model``)
in the port against the JAX package (tiny SD-1.5 and SDXL configs, fp32,
CPU).  The JAX ControlNet trees are random everywhere, the zero-initialised
``conv_out`` and zero convs included, before they are carried across, so
the residuals are not zero; a test shows they move the UNet's output.

Held to JAX: the name map against the port's parameters, the conditioning
embedding and the whole ControlNet (1e-4 + 1e-4 |ref|), the UNet with the
residuals, the engine and the pipeline under CFG (1e-3), the antialiased
resize of the control image; and the loader on a file written here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, flax_init, load_block, random_params, randn, t,
                          tiny_engines, tiny_family_engines)
from sonicdiffusionbayeslab_torch import registry as R
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import sampler as TS
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.controlnet import ConditioningEmbedding, ControlNet
from sonicdiffusionbayeslab_torch.models.pipelines import (
    StableDiffusionControlNetModel,
    resize_bilinear,
)
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_tpu import registry as JR
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import controlnet as JC
from sonicdiffusionbayeslab_tpu.models import pipelines as JP
from sonicdiffusionbayeslab_tpu.models import sampler as JSampler
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.models.unet import UNetConfig as JaxUNetConfig

FAMILIES = ["sd15", "sdxl"]
TIME_IDS = np.tile(np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32), (2, 1))


@functools.lru_cache(maxsize=None)
def _engines(fam):
    """(JAX engine, its params, random JAX ControlNet tree (nonzero heads),
    the port's engine with both loaded): fresh engines of this module's own,
    the JAX engine's compiled loops shared by its tests."""
    jeng, params, teng = (tiny_engines.__wrapped__() if fam == "sd15"
                          else tiny_family_engines.__wrapped__("sdxl"))
    cn = random_params(jax.eval_shape(lambda: jeng.init_controlnet_params(seed=0, latent_hw=8)), 3)
    teng.init_controlnet()
    teng.controlnet.load_state_dict(W.controlnet_state_dict_from_jax(cn, teng.unet_config),
                                    strict=True)
    return jeng, params, cn, teng


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return (request.param, *_engines(request.param))


def _added(fam):
    if fam == "sd15":
        return None, ()
    pooled = randn((2, 16), 4)
    return ({"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(TIME_IDS)},
            (t(pooled), t(TIME_IDS)))


@pytest.mark.parametrize("name", ["sd15", "tiny", "tiny_xl"])
def test_controlnet_map_names_every_port_parameter(name):
    """The JAX ControlNet's parameter paths, through the port's map, are the
    port's state-dict names and shapes (diffusers' ControlNetModel names)."""
    cfg = getattr(UNetConfig, name)()
    jcfg = getattr(JaxUNetConfig, name)()
    added = None
    if cfg.pooled_dim is not None:
        added = {"text_embeds": jnp.zeros((1, cfg.pooled_dim)), "time_ids": jnp.zeros((1, 6))}
    shapes = jax.eval_shape(JC.ControlNet(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, cfg.cross_attention_dim)),
                            jnp.zeros((1, 64, 64, 3)), 1.0, added)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    mapped = {k: v.shape for k, v in W.invert(tree, W.controlnet_name_map(cfg)).items()}
    with torch.device("meta"):
        net = ControlNet(cfg)
    assert mapped == {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert "controlnet_mid_block.weight" in mapped and "controlnet_cond_embedding.blocks.5.weight" \
        in mapped


def test_conditioning_embedding_matches_jax():
    cond = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    params = flax_init(JC.ConditioningEmbedding(32), 2, cond)
    want = JC.ConditioningEmbedding(32).apply({"params": params}, jnp.asarray(cond))

    def fill(m, dst, src):
        m.conv(f"{dst}/conv_in", f"{src}.conv_in")
        for j in range(6):
            m.conv(f"{dst}/blocks_{j}", f"{src}.blocks.{j}")
        m.conv(f"{dst}/conv_out", f"{src}.conv_out")

    block = load_block(ConditioningEmbedding(32), params, fill)
    with torch.inference_mode():
        got = block(t(cond))
    assert got.shape == (2, 8, 8, 32)
    assert_close(got, want, 1e-4, 1e-4)


def _inputs(seed=1):
    return (randn((2, 8, 8, 4), seed), np.array([901.0, 21.0], np.float32),
            randn((2, 77, 32), seed + 1),
            np.random.default_rng(seed + 2).random((2, 64, 64, 3)).astype(np.float32))


def test_controlnet_matches_jax(family):
    """Every residual (13-way split of a tiny UNet's skips, and the mid one)
    within 1e-4 + 1e-4 |ref|, at conditioning scale 0.7, and not zero."""
    fam, jeng, params, cn, teng = family
    x, ts, ctx, cond = _inputs()
    jadded, added = _added(fam)
    want_down, want_mid = jax.jit(jeng.controlnet.apply)(
        {"params": cn}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(cond), 0.7,
        jadded)
    with torch.inference_mode():
        down, mid = teng.controlnet(t(x), t(ts), t(ctx), t(cond), torch.tensor(0.7), *added)
    assert len(down) == len(want_down)
    for g, w in zip((*down, mid), (*want_down, want_mid)):
        assert float(jnp.abs(w).max()) > 1e-3
        assert_close(g, w, 1e-4, 1e-4)


def test_unet_with_residuals_matches_jax_and_they_move_it(family):
    fam, jeng, params, cn, teng = family
    x, ts, ctx, cond = _inputs(5)
    jadded, added = _added(fam)
    res = jax.jit(jeng.controlnet.apply)({"params": cn}, jnp.asarray(x), jnp.asarray(ts),
                                         jnp.asarray(ctx), jnp.asarray(cond), 1.0, jadded)
    want = jax.jit(functools.partial(jeng.unet.apply, control_residuals=res))(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jadded)
    with torch.inference_mode():
        args = (t(x), t(ts), t(ctx), None, None, *added)
        got = teng.denoise(*args, *(None,) * (7 - len(args)), None, None, t(cond),
                           torch.tensor(1.0))
        bare = teng.unet(*args)
    assert_close(got, want, 1e-4, 1e-4)
    assert float((got - bare).abs().max()) > 1e-2  # the residuals move the output


def test_zero_heads_are_an_exact_no_op():
    """A fresh ControlNet (random copy, zero heads) leaves the UNet's output
    bit for bit, SD-1.5 and SDXL, as the JAX package's does."""
    for eng in (TS.StableDiffusionEngine(UNetConfig.tiny(), dtype=torch.float32, device="cpu",
                                         vae_config=TS.VAEConfig.tiny(),
                                         text_config=TS.CLIPTextConfig.tiny()),
                TS.SDXLEngine(UNetConfig.tiny_xl(), TS.VAEConfig.tiny(), TS.SDXLTextConfigs.tiny(),
                              dtype=torch.float32, device="cpu")):
        eng.init_params(1)
        eng.init_controlnet(seed=2)
        x, ts, ctx, cond = _inputs(9)
        added = (() if eng.unet_config.pooled_dim is None
                 else (t(randn((2, 16), 3)), t(TIME_IDS)))
        with torch.inference_mode():
            down, mid = eng.controlnet(t(x), t(ts), t(ctx), t(cond), torch.tensor(1.0), *added)
            assert all(float(r.abs().max()) == 0.0 for r in (*down, mid))
            base = eng.unet(t(x), t(ts), t(ctx), None, None, *added)
            out = eng.unet(t(x), t(ts), t(ctx), None, None, *added,
                           control_residuals=(down, mid))
        assert torch.equal(base, out)


def test_engine_with_controlnet_matches_jax():
    """8-step DPM++ (order 2), CFG 7.5, batch 2, the hint doubled under CFG,
    scale 0.8, from given initial latents: latents and images within 1e-3."""
    jeng, params, cn, teng = _engines("sd15")
    tok = HashTokenizer(vocab_size=1000)  # the pipelines' offline tokenizer
    ids, neg = tok(["a cat", "a dog"]), tok(["", ""])
    lat0 = randn((2, 8, 8, 4), 6)
    cond = np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)
    want = jeng.sample(params, JS.DPMSolverScheduler().build_plan(8),
                       jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg),
                       jax.random.PRNGKey(0), guidance_scale=7.5, latent_hw=(8, 8),
                       init_latents=jnp.asarray(lat0),
                       control={"params": cn, "image": jnp.asarray(cond), "scale": 0.8})
    got = teng.sample(S.DPMSolverScheduler().build_plan(8), teng.encode_prompts(ids),
                      teng.encode_prompts(neg), guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=t(lat0), control={"image": cond, "scale": 0.8})
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)


def test_resize_matches_jax_bilinear():
    """The control image's resize: jax.image.resize's bilinear, antialiased
    when it shrinks (128 -> 64, 100 -> 64) and plain when it grows."""
    rng = np.random.default_rng(3)
    for size in (128, 100, 40):
        img = rng.random((2, size, size, 3)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(img), (2, 64, 64, 3), "bilinear")
        assert_close(resize_bilinear(img, (64, 64)), want, 1e-5)


@pytest.fixture(scope="module")
def pipes():
    """The JAX and the port's ControlNet pipelines (tiny, 64^2, fp32, DPM++)
    on one set of weights, the ControlNet's heads nonzero."""
    jeng, params, cn, teng = _engines("sd15")
    saved = (JP.StableDiffusionModel._load_params,
             JSampler.StableDiffusionEngine.init_controlnet_params)
    JP.StableDiffusionModel._load_params = lambda self, pm, seed: params
    JSampler.StableDiffusionEngine.init_controlnet_params = lambda self, **kw: cn
    try:
        jpipe = JP.StableDiffusionControlNetModel(tiny=True, image_size=64, dtype="float32")
    finally:
        (JP.StableDiffusionModel._load_params,
         JSampler.StableDiffusionEngine.init_controlnet_params) = saved
    jpipe.engine = jeng
    jpipe.scheduler = JS.DPMSolverScheduler(solver_order=2)
    tpipe = StableDiffusionControlNetModel(tiny=True, image_size=64, dtype="float32",
                                           device="cpu")
    tpipe.engine = teng
    return jpipe, tpipe


def test_pipeline_matches_jax(pipes, monkeypatch):
    """8-step DPM++, CFG 7.5, a 128^2 control image the pipelines resize,
    scale 0.9: the JAX pipeline's images within 1e-3 (the port's initial
    latents set to the JAX pipeline's draws)."""
    from sonicdiffusionbayeslab_tpu.utils import rng as jrng

    jpipe, tpipe = pipes
    key = jax.random.PRNGKey(5)
    lat0 = np.asarray(jrng.per_sample_latents(key, jnp.arange(2), (8, 8, 4)))
    monkeypatch.setattr(TS, "per_sample_latents", lambda *a, **kw: t(lat0))
    cond = np.random.default_rng(0).random((2, 128, 128, 3)).astype(np.float32)
    kw = dict(num_inference_steps=8, guidance_scale=7.5, control_image=cond,
              controlnet_scale=0.9)
    want = jpipe(["a cat", "a dog"], key=key, **kw)[0]
    got = tpipe(["a cat", "a dog"], **kw)[0]
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert_close(got, want, 1e-3)
    off = tpipe(["a cat", "a dog"], **{**kw, "controlnet_scale": 0.0})[0]
    assert np.abs(off - got).max() > 1e-3


def test_refusals(pipes):
    """As the JAX package: a call without control_image, DeepCache and a
    microbatch with ControlNet, and an engine without a ControlNet."""
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan

    jpipe, tpipe = pipes
    cond = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="control_image"):
        tpipe(["a cat"], num_inference_steps=2)
    with pytest.raises(ValueError, match="microbatch"):
        tpipe(["a cat"], num_inference_steps=2, control_image=cond, unet_microbatch=2)
    tpipe.cache_plan_fn = lambda n: CachePlan.every(n, 2)
    try:
        with pytest.raises(ValueError, match="DeepCache"):
            tpipe(["a cat"], num_inference_steps=2, control_image=cond)
    finally:
        tpipe.cache_plan_fn = None
    eng = TS.StableDiffusionEngine(UNetConfig.tiny(), TS.VAEConfig.tiny(),
                                   TS.CLIPTextConfig.tiny(), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="init_controlnet"):
        eng.sample(S.DPMSolverScheduler().build_plan(2), torch.zeros(1, 77, 32), None,
                   latent_hw=(8, 8), control={"image": cond})


def test_checkpoint_loads_strictly(tmp_path, pipes):
    """A diffusers-named ControlNet checkpoint written here loads through
    ``controlnet=`` (and a missing key raises)."""
    _, tpipe = pipes
    sd = {k: v.clone() for k, v in tpipe.engine.controlnet.state_dict().items()}
    torch.save(sd, tmp_path / "diffusion_pytorch_model.bin")
    pipe = StableDiffusionControlNetModel(tiny=True, image_size=64, dtype="float32",
                                          device="cpu", controlnet=str(tmp_path))
    got = pipe.engine.controlnet.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    del sd["controlnet_mid_block.bias"]
    torch.save(sd, tmp_path / "diffusion_pytorch_model.bin")
    with pytest.raises(RuntimeError, match="controlnet_mid_block.bias"):
        W.load_controlnet_checkpoint(tmp_path, pipe.engine)


def test_registry_resolves_controlnet_with_the_jax_arguments():
    R.load_all_plugins()
    JR.load_all_plugins()
    assert R.models_registry["stable_diffusion_controlnet_model"] is StableDiffusionControlNetModel
    assert not R.models_registry.not_ported
    port = R.models_registry.arg_specs("stable_diffusion_controlnet_model")
    want = JR.models_registry.arg_specs("stable_diffusion_controlnet_model")
    for name, spec in port.items():
        if name != "device":
            assert spec.default == want[name].default, name
    assert set(want) - set(port) == set()  # the mesh arguments included
