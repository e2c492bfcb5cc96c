"""img2img and inpainting in the port against the JAX package, on the CPU:
the VAE encoder, the schedulers' img2img hooks (``tail_plan``,
``noised_latents``, ``blend_schedule``), the mask resize, the pipeline's
img2img and inpainting under CFG with the JAX pipeline's own draws passed
in, the reference's refusals, and ``generate.py``'s img2img, inpainting
and DeepCache flags (tiny models, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.layers import Downsample
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel, resize_mask
from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig
from sonicdiffusionbayeslab_torch.models.weights import invert, vae_name_map
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import layers as JL
from sonicdiffusionbayeslab_tpu.models import pipelines as JP
from sonicdiffusionbayeslab_tpu.models import vae as JV
from torch_parity import (assert_close, flax_init, load_block, randn, random_params, t,
                          tiny_engines)

torch.set_num_threads(1)

BUILDERS = {
    "ddim": (S.DDIMScheduler, JS.DDIMScheduler, {}),
    "dpm_solver": (S.DPMSolverScheduler, JS.DPMSolverScheduler, {"solver_order": 2}),
    "dpm_solver_karras": (S.DPMSolverScheduler, JS.DPMSolverScheduler,
                          {"solver_order": 3, "use_karras_sigmas": True}),
    "deis": (S.DEISScheduler, JS.DEISScheduler, {}),
    "lcm": (S.LCMScheduler, JS.LCMScheduler, {}),
    "unipc": (S.UniPCScheduler, JS.UniPCScheduler, {}),
    "euler": (S.EulerScheduler, JS.EulerScheduler, {}),
    "euler_karras": (S.EulerScheduler, JS.EulerScheduler, {"use_karras_sigmas": True}),
    "euler_ancestral": (S.EulerAncestralScheduler, JS.EulerAncestralScheduler, {}),
    "heun": (S.HeunScheduler, JS.HeunScheduler, {}),
    "pndm": (S.PNDMScheduler, JS.PNDMScheduler, {}),
}
N_STEPS = 10
STARTS = (0, 1, N_STEPS // 2, N_STEPS - 1)


# ----------------------------------------------------------------- encoder
@pytest.fixture(scope="module")
def vaes():
    """{name: (JAX AutoencoderKL, its numpy params, the port's loaded with
    them)}: the tiny geometry and a three-level one (two stride-2 convs, two
    resnets a level)."""
    out = {}
    for name, cfg in (("tiny", dict(block_out_channels=(16, 32), layers_per_block=1)),
                      ("three_levels", dict(block_out_channels=(16, 32, 32), layers_per_block=2))):
        jvae = JV.AutoencoderKL(JV.VAEConfig(**cfg))
        shapes = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)),
                                                  method=jvae.init_all))
        params = random_params(shapes["params"], 3)
        n = len(cfg["block_out_channels"])
        sd = invert(params, vae_name_map(n, cfg["layers_per_block"]))
        tvae = AutoencoderKL(VAEConfig(**cfg)).eval()
        tvae.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
        out[name] = (jvae, params, tvae)
    return out


@pytest.mark.parametrize("name", ["tiny", "three_levels"])
def test_encoder_moments_and_sample_match_jax(vaes, name):
    """(mean, logvar) and ``encode_sample`` with the JAX draw passed in:
    within 1e-4 + 1e-4 |ref|, on an image whose sides (20 x 12) exercise
    the encoder's bottom/right padding."""
    jvae, params, tvae = vaes[name]
    x = np.clip(randn((2, 20, 12, 3), 1, 0.6), -1, 1)
    mean, logvar = jvae.apply({"params": params}, jnp.asarray(x), method=jvae.encode)
    key = jax.random.PRNGKey(7)
    z = jvae.apply({"params": params}, jnp.asarray(x), key, method=jvae.encode_sample)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    with torch.no_grad():
        got_mean, got_logvar = tvae.encode(t(x))
        got_z = tvae.encode_sample(t(x), t(noise))
    assert got_mean.shape == tuple(mean.shape) and got_mean.dtype == torch.float32
    assert_close(got_mean, mean, 1e-4, 1e-4)
    assert_close(got_logvar, logvar, 1e-4, 1e-4)
    assert_close(got_z, z, 1e-4, 1e-4)


def test_asymmetric_downsample_matches_jax():
    """The encoder's stride-2 conv padded at the bottom and right only, at
    odd and even sides."""
    mod = JL.Downsample(8, asymmetric_pad=True)
    for hw in ((9, 7), (8, 6)):
        x = randn((2, *hw, 8), 2)
        params = flax_init(mod, 4, x)
        tmod = load_block(Downsample(8, asymmetric_pad=True), params,
                          lambda m, d, s: m.conv(f"{d}/conv", f"{s}.conv"))
        with torch.no_grad():
            got = tmod(t(x))
        want = mod.apply({"params": params}, jnp.asarray(x))
        assert got.shape == tuple(want.shape)
        assert_close(got, want, 1e-5, 1e-5)


def test_decoder_only_checkpoint_loads_and_refuses_to_encode():
    """A VAE state dict without the encoder's keys loads (text-to-image
    still decodes), and an encode raises instead of using random weights."""
    src = AutoencoderKL(VAEConfig.tiny())
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith(("encoder.", "quant_conv."))}
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(sd, strict=True)
    assert not vae.has_encoder
    z = randn((1, 8, 8, 4), 3)
    with torch.no_grad():
        assert torch.equal(vae.decode(t(z)), src.decode(t(z)))
        with pytest.raises(RuntimeError, match="encoder"):
            vae.encode(torch.zeros(1, 16, 16, 3))
    vae.load_state_dict(src.state_dict(), strict=True)
    assert vae.has_encoder
    with pytest.raises(RuntimeError, match="Missing key"):
        vae.load_state_dict({k: v for k, v in sd.items() if k != "decoder.conv_in.bias"})


# -------------------------------------------------------------- schedulers
def _assert_plans_equal(got, want):
    assert got.name == want.name and got.init_scale == want.init_scale
    for k, v in want.scan_xs().items():
        np.testing.assert_array_equal(got.scan_xs()[k], v, err_msg=k)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_tail_plan_rows_bit_equal_to_jax(name, start):
    port, ref, kw = BUILDERS[name]
    if name == "pndm" and start:
        for cls in (port, ref):
            with pytest.raises(NotImplementedError, match="PLMS"):
                cls(**kw).tail_plan(N_STEPS, start)
        return
    _assert_plans_equal(port(**kw).tail_plan(N_STEPS, start), ref(**kw).tail_plan(N_STEPS, start))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_noised_latents_and_blend_schedule_bit_equal_to_jax(name):
    port, ref, kw = BUILDERS[name]
    z, noise = randn((2, 8, 8, 4), 4), randn((2, 8, 8, 4), 5)
    for start in STARTS:
        got = port(**kw).noised_latents(t(z), t(noise), N_STEPS, start)
        want = ref(**kw).noised_latents(jnp.asarray(z), jnp.asarray(noise), N_STEPS, start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(start))
        if name == "pndm":
            for b in (port(**kw), ref(**kw)):
                with pytest.raises(NotImplementedError, match="PLMS"):
                    b.blend_schedule(N_STEPS, start)
            continue
        a, s = port(**kw).blend_schedule(N_STEPS, start)
        ja, js = ref(**kw).blend_schedule(N_STEPS, start)
        assert a.dtype == s.dtype == np.float32
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(s, js)
        assert len(a) == port(**kw).tail_plan(N_STEPS, start).num_steps


@pytest.mark.parametrize("size_in,size_out", [((37, 45), (5, 6)), ((64, 64), (8, 8)),
                                               ((70, 21), (9, 3)), ((5, 7), (11, 13))])
def test_mask_resize_bit_equal_to_jax_nearest(size_in, size_out):
    m = (np.random.default_rng(6).random((2, *size_in)) > 0.5).astype(np.float32)
    got = resize_mask(m, size_out)
    want = jax.image.resize(jnp.asarray(m[..., None]), (2, *size_out, 1), "nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def pipes():
    """The JAX tiny pipeline on the shared tiny engine and params, and the
    port's loaded with the same weights, both fp32 with DPM++ (order 2)."""
    jeng, params, teng = tiny_engines()
    saved = JP.StableDiffusionModel._load_params
    JP.StableDiffusionModel._load_params = lambda self, pm, seed: params
    try:
        jpipe = JP.StableDiffusionModel(tiny=True, dtype="float32")
    finally:
        JP.StableDiffusionModel._load_params = saved
    jpipe.engine = jeng
    jpipe.scheduler = JS.DPMSolverScheduler(solver_order=2)
    tpipe = StableDiffusionModel(tiny=True, dtype="float32", device="cpu")
    tpipe.engine = teng
    return jpipe, tpipe


def _jax_draws(key, shape):
    """The JAX pipeline's and engine's img2img draws from ``key``: the
    encoder's posterior sample, the start noise and the blend noise."""
    key, enc_key, noise_key = jax.random.split(key, 3)
    return dict(encode_noise=np.asarray(jax.random.normal(enc_key, shape)),
                init_noise=np.asarray(jax.random.normal(noise_key, shape, jnp.float32)),
                blend_noise=np.asarray(jax.random.normal(jax.random.fold_in(key, 0xB1E0D), shape,
                                                         jnp.float32)))


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_pipeline_img2img_matches_jax(pipes, mode):
    """10-step DPM++ at strength 0.7 (7 rows), CFG 7.5, batch 2; inpainting
    with a mask whose sides (16 x 16 image, 8 x 8 latents) resize by
    nearest: images within 1e-3, and the kept region's latents the clean
    source's after the last row."""
    jpipe, tpipe = pipes
    img = np.random.default_rng(8).random((2, 16, 16, 3)).astype(np.float32)
    kw = dict(num_inference_steps=10, guidance_scale=7.5, init_image=img, strength=0.7)
    if mode == "inpaint":
        mask = np.zeros((2, 16, 16), np.float32)
        mask[:, 3:13, 5:] = 1.0
        kw["mask_image"] = mask
    key = jax.random.PRNGKey(11)
    prompts = ["a red boat", "a lighthouse"]
    want = jpipe(prompts, key=key, **kw)[0]
    draws = _jax_draws(key, (2, 8, 8, 4))
    got = tpipe(prompts, **kw, **draws)[0]
    assert tpipe.num_timesteps == jpipe.num_timesteps == 7
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert_close(got, want, 1e-3)
    if mode == "inpaint":
        lat = tpipe(prompts, output_type="latent", **kw, **draws)[0]
        z = tpipe.engine.encode_image(img, t(draws["encode_noise"])).numpy()
        keep = resize_mask(kw["mask_image"], (8, 8)).numpy()[..., 0] == 0
        np.testing.assert_array_equal(lat[keep], z[keep])


def test_pipeline_img2img_refusals(pipes):
    """The JAX pipeline's refusals: no step left, a mask without an image,
    height/width with an image; and PLMS's inpainting blend."""
    jpipe, tpipe = pipes
    img = np.zeros((1, 16, 16, 3), np.float32)
    mask = np.ones((1, 16, 16), np.float32)
    cases = [(dict(init_image=img, strength=0.0), ValueError, "no steps"),
             (dict(mask_image=mask), ValueError, "mask_image requires init_image"),
             (dict(init_image=img, height=16), ValueError, "text2img-only")]
    for kw, exc, match in cases:
        for pipe in (jpipe, tpipe):
            with pytest.raises(exc, match=match):
                pipe(["a"], num_inference_steps=4, **kw)
    for pipe, sched in ((jpipe, JS.PNDMScheduler()), (tpipe, S.PNDMScheduler())):
        saved, pipe.scheduler = pipe.scheduler, sched
        try:
            with pytest.raises(NotImplementedError, match="PLMS"):
                pipe(["a"], num_inference_steps=4, init_image=img, strength=1.0, mask_image=mask)
        finally:
            pipe.scheduler = saved


# -------------------------------------------------------------- generate.py
@pytest.mark.parametrize("flags", [["--init_image", "{img}"],
                                   ["--init_image", "{img}", "--mask_image", "{mask}",
                                    "--strength", "0.5"],
                                   ["--cache_interval", "2", "--cache_branch_id", "0"]])
def test_generate_img2img_inpaint_and_deepcache_flags(flags, tmp_path, monkeypatch, capsys):
    """``generate.py`` on the tiny model: each flag set writes one PNG a
    prompt, the same pixels as the pipeline called with what the flags
    mean."""
    from sonicdiffusionbayeslab_torch import generate
    from sonicdiffusionbayeslab_torch.data.imageio import read_image, write_png
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan

    rng = np.random.default_rng(9)
    write_png(tmp_path / "in.png", rng.random((24, 24, 3)).astype(np.float32))
    m = np.zeros((24, 24, 3), np.float32)
    m[:, 12:] = 1.0
    write_png(tmp_path / "mask.png", m)
    argv = [f.format(img=tmp_path / "in.png", mask=tmp_path / "mask.png") for f in flags]
    out = tmp_path / "out_{i:03d}.png"
    generate.main(["--prompt", "a boat", "--prompt", "a cat", "--tiny", "--device", "cpu",
                   "--steps", "4", "--out", str(out), *argv])
    assert capsys.readouterr().out.count("wrote") == 2
    pipe = StableDiffusionModel(tiny=True, device="cpu")
    kw = dict(num_inference_steps=4, guidance_scale=7.5, negative_prompt=["", ""], seed=29)
    if "--init_image" in flags:
        img = read_image(tmp_path / "in.png", image_size=16)
        kw.update(init_image=np.stack([img, img]),
                  strength=0.5 if "--strength" in flags else 0.8)
        if "--mask_image" in flags:
            mm = read_image(tmp_path / "mask.png", image_size=16).mean(-1, keepdims=True) > 0.5
            kw["mask_image"] = np.stack([mm, mm]).astype(np.float32)
    else:
        pipe.cache_plan_fn = lambda n: CachePlan.every(n, 2, 0)
    want = pipe(["a boat", "a cat"], **kw)[0]
    for i in range(2):
        got = read_image(str(out).format(i=i))
        np.testing.assert_allclose(got, np.round(want[i] * 255) / 255, atol=1.5 / 255)
