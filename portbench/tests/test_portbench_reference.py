"""The plain reference against the port at the tiny geometry, float32 on
the CPU: each network on the same weights (the benchmark's), and the
whole pipeline call, image for image."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference.sample import Pipeline, build_nets, initial_latents
from portbench.tests.tiny import tiny_config
from portbench.traffic import offline
from portbench.weights import make_weights

CONFIGS = ("sd15", "sdxl")


def both(name, seed=5):
    cfg = tiny_config(name)
    pipe = offline.build_pipeline(cfg, "cpu")
    weights = make_weights(cfg, seed, "cpu", torch.float32)
    offline.load_program_weights(pipe, cfg, weights)
    models = build_nets(cfg, "meta")
    for n, sd in weights.items():
        models[n].load_state_dict(sd, strict=True, assign=True)
    return cfg, pipe, models


@pytest.mark.parametrize("name", CONFIGS)
def test_networks_match_the_port(name):
    cfg, pipe, models = both(name)
    eng = pipe.engine
    ref = Pipeline(cfg, models)
    prompts = ["a red bus parked by a curb", "two dogs"]
    ctx, pooled = ref.encode(prompts)
    pctx = pipe._encode(prompts)
    torch.testing.assert_close(ctx, pctx, atol=1e-5, rtol=1e-5)
    added, padded = {}, {}
    if name == "sdxl":
        torch.testing.assert_close(pooled, pipe._pooled_queue.pop(), atol=1e-5, rtol=1e-5)
        ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]]).repeat(2, 1)
        added = {"pooled": pooled, "time_ids": ids}
        padded = {"text_embeds": pooled, "time_ids": ids}
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([801.0, 1.0])
    with torch.no_grad():
        want = models["unet"](x, t, ctx, **added)
        got = eng.unet(x.permute(0, 2, 3, 1), t, ctx, **padded).permute(0, 3, 1, 2)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(eng.vae.decode(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2),
                                   models["vae"](z), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_pipeline_call_matches_the_port(name):
    cfg, pipe, models = both(name, seed=2**31 + 77)
    prompts = ["a kitchen with a stove", "a man riding a wave", "a plate of food"]
    images, _, _ = pipe(prompts, num_inference_steps=4, guidance_scale=7.5, seed=123,
                        negative_prompt=[""] * 3)
    want = Pipeline(cfg, models).images(prompts, 123, [0, 1, 2], 4, 7.5, "")
    np.testing.assert_allclose(images, want.numpy(), atol=5e-5)


def test_initial_latents_are_the_ports_draws():
    from sonicdiffusionbayeslab_torch.utils.rng import per_sample_latents

    got = per_sample_latents(2**31 + 9, [0, 3], (8, 8, 4))
    want = torch.stack([initial_latents(2**31 + 9, i, 4, 8, 8) for i in (0, 3)])
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=0, rtol=0)


def test_hash_tokenizer_is_the_ports():
    from sonicdiffusionbayeslab_torch.models.tokenizer import HashTokenizer as Port

    from portbench.reference.sample import HashTokenizer

    texts = ["A man on a snowboard", "", "word " * 90]
    np.testing.assert_array_equal(HashTokenizer(49408, 77)(texts), Port(49408, 77)(texts))
