"""The port's w-conditioned (full LCM) UNet against the JAX package (tiny
configs with ``time_cond_proj_dim`` 8, fp32, CPU, JAX trees from
``jax.eval_shape``): the guidance embedding, the UNet's ``cond_proj`` and
its guard, the weight names, and the engine's LCM sampling with the
embedding of ``guidance_scale - 1`` through ``sample`` (whole and in
microbatch chunks; without CFG and with it).

Tolerances.  The embedding: 1e-6 + 2^-22·|a| at a sine's argument a = w ·
1000 · f_i.  The port takes exp, sin and cos in float64 of its fp32
arguments and rounds; XLA's fp32 exp is an ulp off that at some
frequencies (dim 8's second: 0.046415888 against 0.046415891), and an ulp
of f_i moves a by |a|·2^-23, up to 1.4e4 x that here.
The UNet: 1e-4 + 1e-4·|ref| (fp32 through the same ~20 convs and matmuls,
summation order apart).  The engine runs: 1e-3, as the other engines'
tests (fp32 over the LCM steps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, jax_step_noise, random_params, randn, t
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import (StableDiffusionEngine,
                                                         guidance_scale_embedding)
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_tpu import models as jm
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import sampler as JSam
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

DIM = 8


@pytest.fixture(scope="module")
def engines():
    """(JAX w-conditioned tiny engine, its random numpy params, the port's
    twin loaded with the same weights), fp32."""
    jeng = jm.StableDiffusionEngine(dataclasses.replace(jm.UNetConfig.tiny(),
                                                        time_cond_proj_dim=DIM),
                                    jm.VAEConfig.tiny(), jm.CLIPTextConfig.tiny(),
                                    dtype=jnp.float32, param_dtype=jnp.float32)
    params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 0)
    teng = StableDiffusionEngine(dataclasses.replace(UNetConfig.tiny(), time_cond_proj_dim=DIM),
                                 VAEConfig.tiny(), CLIPTextConfig.tiny(), dtype=torch.float32,
                                 device="cpu")
    teng.load_state_dicts(W.state_dicts_from_jax(params))
    return jeng, params, teng


@pytest.mark.parametrize("dim", [8, 7, 256])
def test_guidance_scale_embedding_matches_jax(dim):
    w = np.array([0.0, 1.0, 6.5, 14.0], np.float32)
    want = np.asarray(JSam.guidance_scale_embedding(jnp.asarray(w), dim))
    got = guidance_scale_embedding(t(w), dim)
    assert got.shape == want.shape == (4, dim) and got.dtype == torch.float32
    half = dim // 2
    arg = 1000.0 * w[:, None] * np.exp(np.arange(half) * -np.log(10000.0) / (half - 1))
    tol = 1e-6 + 2.0**-22 * np.abs(np.concatenate([arg, arg], axis=1))
    err = np.abs(got.numpy()[:, :2 * half] - want[:, :2 * half])
    assert (err <= tol).all(), (err - tol).max()
    assert_close(got[:1], want[:1], 1e-6)  # w = 0: sin 0 and cos 0
    if dim % 2:
        assert torch.all(got[:, -1] == 0)


def test_wcond_unet_matches_jax_and_needs_timestep_cond(engines):
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([501.0, 19.0], np.float32)
    apply = jax.jit(jeng.unet.apply)
    outs = []
    for w in (7.0, 0.0):
        emb = np.asarray(JSam.guidance_scale_embedding(jnp.full((2,), w), DIM))
        want = apply({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                     jnp.asarray(ctx), timestep_cond=jnp.asarray(emb))
        with torch.no_grad():
            got = teng.unet(t(x), t(ts), t(ctx), timestep_cond=t(emb))
        assert_close(got, want, 1e-4, 1e-4)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max() > 1e-6  # w conditions the output
    with pytest.raises(ValueError, match="timestep_cond") as jerr:
        jeng.unet.apply({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx))
    with pytest.raises(ValueError, match="timestep_cond") as terr:
        teng.unet(t(x), t(ts), t(ctx))
    assert str(terr.value) == str(jerr.value)


def test_a_plain_unet_ignores_timestep_cond():
    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig.tiny()).eval()
    x, ctx, ts = torch.randn(1, 8, 8, 4), torch.randn(1, 77, 32), torch.tensor([3.0])
    with torch.no_grad():
        assert torch.equal(unet(x, ts, ctx), unet(x, ts, ctx, timestep_cond=torch.ones(1, DIM)))
    assert not hasattr(unet.time_embedding, "cond_proj")


def test_cond_proj_names_and_strict_load(engines):
    """``time_embedding/cond_proj`` (bias-free) maps to diffusers'
    ``time_embedding.cond_proj.weight``; the tree's geometry has the
    width; the state dict loads strictly only into a w-conditioned UNet."""
    _, params, teng = engines
    sds = W.state_dicts_from_jax(params)
    kernel = params["unet"]["time_embedding"]["cond_proj"]["kernel"]
    assert np.array_equal(sds["unet"]["time_embedding.cond_proj.weight"].numpy(),
                          np.float32(kernel).T)
    assert "time_embedding.cond_proj.bias" not in sds["unet"]
    assert W.unet_geometry(params["unet"]).time_cond_proj_dim == DIM
    assert set(sds["unet"]) == set(teng.unet.state_dict())
    with pytest.raises(RuntimeError, match="cond_proj"):
        UNet2DCondition(UNetConfig.tiny()).load_state_dict(sds["unet"], strict=True)


@pytest.fixture(scope="module")
def prompts():
    tok = HashTokenizer(vocab_size=1000)
    return tok(["a cat", "a dog"]), tok(["", ""])


@pytest.mark.parametrize("guidance,cfg,microbatch", [
    (8.0, False, None), (8.0, False, 2), (3.0, True, 2)])
def test_wcond_engine_lcm_sample_matches_jax(engines, prompts, guidance, cfg, microbatch):
    """4 LCM steps, their noise the JAX engine's: without CFG (the full LCM
    way: the guidance only embedded) and with it (the embedding on every
    row of the doubled batch), whole and in chunks of the model batch."""
    jeng, params, teng = engines
    ids, neg_ids = prompts
    lat0, idx, key = randn((2, 8, 8, 4), 6), [0, 1], jax.random.PRNGKey(3)
    neg = jeng.encode_prompts(params, neg_ids) if cfg else None
    want = jeng.sample(params, JS.LCMScheduler().build_plan(4), jeng.encode_prompts(params, ids),
                       neg, key, guidance_scale=guidance, latent_hw=(8, 8),
                       init_latents=jnp.asarray(lat0), microbatch=microbatch)
    noise = jax_step_noise(key, idx, 4, (8, 8, 4))
    got = teng.sample(S.LCMScheduler().build_plan(4), teng.encode_prompts(ids),
                      teng.encode_prompts(neg_ids) if cfg else None, guidance_scale=guidance,
                      latent_hw=(8, 8), init_latents=t(lat0), step_noise=t(noise),
                      microbatch=microbatch)
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)
    other = teng.sample(S.LCMScheduler().build_plan(4), teng.encode_prompts(ids), None,
                        guidance_scale=2.0, latent_hw=(8, 8), init_latents=t(lat0),
                        step_noise=t(noise))
    assert (other.images - got.images).abs().max() > 1e-6  # the embedding reaches the UNet


def test_graphed_calls_copy_the_embedding_in_and_never_replay_another_signature(
        engines, monkeypatch):
    """``engine.graphed_unet`` with a replay simulated on the CPU (the
    captured call run again on the static inputs): ``timestep_cond`` is a
    positional tensor, so a replay with another w's embedding gives that
    w's output, bit-equal to the eager call; a call without it has another
    signature and is captured anew (and refused), never a replay."""
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    class Graph:
        def __init__(self, fn, static_in, out):
            self.fn, self.static_in, self.out = fn, static_in, out

        def replay(self):
            self.out.copy_(self.fn(*self.static_in))

    def capture(self, args):
        static_in = [None if a is None else a.clone() for a in args]
        out = self.fn(*static_in)
        return Graph(self.fn, static_in, out), static_in, out

    monkeypatch.setattr(GraphedCall, "_capture", capture)
    _, _, teng = engines
    teng.weights_changed()
    x, ctx = t(randn((2, 8, 8, 4), 1)), t(randn((2, 77, 32), 2))
    ts = torch.tensor([501.0, 19.0])
    with torch.no_grad():
        for w in (7.0, 1.5):
            emb = guidance_scale_embedding(torch.full((2,), w), DIM)
            got = teng.graphed_unet(x, ts, ctx, *(None,) * 8, emb)
            assert torch.equal(got, teng.denoise(x, ts, ctx, timestep_cond=emb))
        assert teng.graphed_unet.captures == {(): 1}
        with pytest.raises(ValueError, match="timestep_cond"):
            teng.graphed_unet(x, ts, ctx)
    teng.weights_changed()
