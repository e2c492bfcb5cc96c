"""The port's Token Merging (ops/tome.py, the transformer hooks, the UNet's
ToMe slots and the engine's destinations) against the JAX package's
(tiny configs, fp32, CPU).

ToMe keeps the sources with the best similarity scores; which sources
merge, and the output, must match JAX's.  The order of the merged rows
does not matter to the attention between merge and unmerge (SD attention
has no positional term), so only sets and unmerged outputs are compared.
Destinations come from the JAX package's own key chain, passed in, as the
port draws its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, flax_init, jax_tome_destinations, load_block, randn, t,
                          tiny_engines)
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
from sonicdiffusionbayeslab_torch.ops.tome import (TomeConfig, bipartite_soft_matching_2d,
                                                  dst_index_grid)
from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall, GraphedVariants
from sonicdiffusionbayeslab_torch.utils.rng import tome_destinations
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import layers as FL
from sonicdiffusionbayeslab_tpu.models.sampler import CachePlan as JCachePlan
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.ops import tome as JT


def _jax_cfg(cfg: TomeConfig):
    return JT.TomeConfig(cfg.ratio, cfg.sx, cfg.sy, cfg.max_downsample, cfg.rand,
                         cfg.metric_channels, cfg.share)


def _kept_sources(merged_tags, n_kept):
    """Each row's kept sources, from the merge of the token indices
    [B, N, 1]: kept sources are copied into the first n_kept rows (the
    destinations' means follow).  With the same destinations, the same kept
    sources mean the same merged ones."""
    return [frozenset(np.rint(row[:n_kept, 0]).astype(int)) for row in np.asarray(merged_tags)]


# ---------------------------------------------------------------- op level
def test_merge_unmerge_shapes():
    x = torch.as_tensor(randn((2, 64, 16), 0))
    cfg = TomeConfig(ratio=0.5)
    assert cfg.r_for(8, 8) == 32  # min(64 * 0.5, 64 - 16 destinations)
    merge, unmerge = bipartite_soft_matching_2d(x, 8, 8, cfg, dst_index_grid(8, 8, 2, 2))
    y = merge(x)
    assert y.shape == (2, 32, 16) and unmerge(y).shape == (2, 64, 16)
    # A matching built at batch 2 serves a batch of 4 (each copy matched alike).
    assert torch.equal(merge(torch.cat([x, x]))[2:], y)


def test_ratio_capped_at_src_count():
    assert TomeConfig(ratio=0.95).r_for(8, 8) == 64 - 16
    assert TomeConfig(ratio=0.5).r_for(64, 64) == 2048
    assert TomeConfig(ratio=0.25).r_for(64, 64) == 1024


def test_constant_tokens_roundtrip_exact():
    """Identical tokens average to themselves."""
    x = torch.full((2, 64, 8), 3.25)
    merge, unmerge = bipartite_soft_matching_2d(x, 8, 8, TomeConfig(0.5),
                                                dst_index_grid(8, 8, 2, 2, torch.Generator()))
    assert torch.equal(unmerge(merge(x)), x)


def test_kept_tokens_pass_through_exactly():
    """Merge then unmerge is the identity on each of the n_src - r kept
    sources; every token reads a row of the merged set."""
    x = torch.as_tensor(randn((1, 64, 4), 3))
    cfg = TomeConfig(ratio=0.25)
    merge, unmerge = bipartite_soft_matching_2d(
        x, 8, 8, cfg, dst_index_grid(8, 8, 2, 2, torch.Generator().manual_seed(3)))
    y, z = merge(x), unmerge(merge(x))
    assert (z == x).all(-1).sum() >= 64 - 16 - cfg.r_for(8, 8)
    assert all((y[0] == row).all(-1).any() for row in z[0])


def test_config_hashable_and_validated():
    assert hash(TomeConfig(0.5)) == hash(TomeConfig(0.5)) and TomeConfig(0.5) == TomeConfig(0.5)
    assert TomeConfig(0.5) != TomeConfig(0.4) and TomeConfig(0.5) != TomeConfig(0.5, rand=False)
    assert repr(TomeConfig(0.5)) == repr(JT.TomeConfig(0.5))
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            TomeConfig(ratio=bad)


def test_destination_draws():
    """In-cell draws (one per cell, inside it), keyed by (timestep, site,
    block) alone, zero-padded to the widest slot."""
    g = dst_index_grid(8, 12, 2, 2, torch.Generator().manual_seed(0))
    cells = (g // 12) // 2 * 6 + (g % 12) // 2
    assert g.shape == (24,) and torch.equal(cells, torch.arange(24))
    assert torch.equal(dst_index_grid(4, 4, 2, 2), torch.tensor([0, 2, 8, 10]))
    slots = [(0, 0, 8, 8), (1, 0, 4, 4), (1, 1, 4, 4)]
    d = tome_destinations(901, slots, TomeConfig())
    assert d.shape == (3, 16) and torch.equal(d, tome_destinations(901, slots, TomeConfig()))
    assert not torch.equal(d[1, :4], d[2, :4]) or not torch.equal(d, tome_destinations(
        881, slots, TomeConfig()))
    assert (d[1:, 4:] == 0).all()


MATCH_CASES = {  # (B, h, w, C, ratio, metric_channels, seed)
    "16x16_c80_metric64": (2, 16, 16, 80, 0.5, 64, 1),
    "8x12_r0.25_all_channels": (3, 8, 12, 8, 0.25, 0, 2),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_matching_matches_jax(case):
    """With JAX's random destinations, the same merged sources and the same
    unmerge(merge(x)), also on a batch twice the matching's."""
    B, h, w, C, ratio, mc, seed = MATCH_CASES[case]
    x = randn((B, h * w, C), seed)
    cfg = TomeConfig(ratio, metric_channels=mc)
    key = jax.random.PRNGKey(seed + 10)
    dst = torch.as_tensor(np.array(JT._dst_index_grid(h, w, 2, 2, key)), dtype=torch.int64)
    tags = np.arange(h * w, dtype=np.float32)[None, :, None].repeat(B, 0)
    x2 = np.concatenate([x, x[::-1]])

    @jax.jit
    def jax_side(x, tags, x2):
        merge, unmerge = JT.bipartite_soft_matching_2d(x, h, w, _jax_cfg(cfg), key)
        return merge(tags), unmerge(merge(x2))

    jtags, jround = jax_side(x, tags, x2)
    tm, tu = bipartite_soft_matching_2d(t(x), h, w, cfg, dst)
    n_kept = h * w - len(dst) - cfg.r_for(h, w)
    assert _kept_sources(tm(t(tags)), n_kept) == _kept_sources(jtags, n_kept)
    # fp32 means of the same few rows, summed in another order.
    assert_close(tu(tm(t(x2))), jround, 1e-6)


def test_indivisible_map_is_skipped_in_transformer():
    """A 7 x 6 map has no 2 x 2 tiling: the transformer runs without ToMe."""
    st = L.SpatialTransformer(8, 2, 4, 8).eval()
    x, ctx = t(randn((1, 7, 6, 8), 6)), t(randn((1, 5, 8), 7))
    with torch.inference_mode():
        assert torch.equal(st(x, ctx, TomeConfig(0.5), torch.zeros(1, 9, dtype=torch.int64)),
                           st(x, ctx))


@pytest.mark.parametrize("share", [True, False])
def test_spatial_transformer_with_tome_matches_jax(share):
    """Two blocks over a 4 x 4 map, each merging around its self-attention
    with its own destinations (JAX: block i's key folds i in), or both with
    the first block's matching when shared."""
    cfg = TomeConfig(0.5, share=share)
    x_map, ctx = randn((2, 4, 4, 32), 0), randn((2, 77, 24), 2)
    flax_mod = FL.SpatialTransformer(2, 16, depth=2)
    params = flax_init(flax_mod, 0, x_map, ctx)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, x, c: flax_mod.apply(
        {"params": p}, x, c, tome=_jax_cfg(cfg), tome_key=key, tome_cache={}))(
        params, jnp.asarray(x_map), jnp.asarray(ctx))
    dst = torch.as_tensor(np.stack([np.asarray(JT._dst_index_grid(
        4, 4, 2, 2, jax.random.fold_in(key, i))) for i in range(2)]), dtype=torch.int64)
    mod = load_block(L.SpatialTransformer(32, 2, 16, 24, depth=2), params,
                     lambda m, d, s: m.spatial_transformer(d, s, 2))
    with torch.inference_mode():
        got = mod(t(x_map), t(ctx), cfg, dst, {})
        plain = mod(t(x_map), t(ctx))
    assert_close(got, want, 5e-5)  # fp32, as the plain block test
    assert not torch.allclose(got, plain, atol=1e-3)


def test_transformer_block_with_tome_matches_jax():
    cfg = TomeConfig(0.5)
    tokens, ctx = randn((2, 16, 32), 1), randn((2, 77, 24), 2)
    flax_mod = FL.TransformerBlock(2, 16)
    params = flax_init(flax_mod, 0, tokens, ctx)
    key = jax.random.PRNGKey(9)
    want = flax_mod.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(ctx),
                          tome=_jax_cfg(cfg), tome_hw=(4, 4), tome_key=key)
    dst = torch.as_tensor(np.array(JT._dst_index_grid(4, 4, 2, 2, key)), dtype=torch.int64)
    mod = load_block(L.TransformerBlock(32, 2, 16, 24), params,
                     lambda m, d, s: m.transformer_block(d, s))
    with torch.inference_mode():
        assert_close(mod(t(tokens), t(ctx), cfg, (4, 4), dst), want, 5e-5)


# ------------------------------------------------------------- UNet, engine
@pytest.fixture(scope="module")
def engines():
    return tiny_engines()


def test_unet_tome_slots_match_jax(engines):
    """The tiny UNet's ToMe slots at max_downsample 2 (the 8 x 8 down
    transformer, the 4 x 4 mid block, its destinations padded, the two 8 x
    8 up transformers; the first and the last two at max_downsample 1) with
    the JAX UNet's per-site destinations, unshared: the same output."""
    jeng, params, teng = engines
    cfg = TomeConfig(0.5, max_downsample=2, share=False)
    slots = teng.unet.tome_slots(8, 8, cfg)
    assert slots == [(0, 0, 8, 8), (1, 0, 4, 4), (2, 0, 8, 8), (3, 0, 8, 8)]
    assert teng.unet.tome_slots(8, 8, TomeConfig()) == [(0, 0, 8, 8), (1, 0, 8, 8),
                                                        (2, 0, 8, 8)]
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 901.0], np.float32)
    want = jax.jit(jeng.unet.apply, static_argnames=("tome",))(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        tome=_jax_cfg(cfg))
    key = jax.random.fold_in(jax.random.PRNGKey(0x703E), 901)
    dst = torch.zeros(len(slots), 16, dtype=torch.int64)
    for k, (site, block, h, w) in enumerate(slots):
        g = np.array(JT._dst_index_grid(h, w, 2, 2, jax.random.fold_in(
            jax.random.fold_in(key, site), block)))
        dst[k, :len(g)] = torch.as_tensor(g)
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx), None, dst, tome=cfg)
    assert_close(got, want, 1e-4)  # fp32 through ~20 convs/matmuls, as the plain UNet test
    with pytest.raises(ValueError, match="tome_dst"):
        teng.unet(t(x), t(ts), t(ctx), tome=cfg)


@pytest.fixture(scope="module")
def inputs(engines):
    jeng, params, teng = engines
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    return dict(lat0=randn((2, 8, 8, 4), 8),
                jax=(jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg_ids)),
                torch=(teng.encode_prompts(ids), teng.encode_prompts(neg_ids)))


ENGINE_RUNS = {  # name: (TomeConfig, DeepCache interval or None, unet_microbatch)
    "fixed_destinations": (TomeConfig(0.5, rand=False), None, None),
    "jax_destinations": (TomeConfig(0.5), None, None),
    "deep_cache_microbatch_2": (TomeConfig(0.5), 2, 2),
}


@pytest.mark.parametrize("name", sorted(ENGINE_RUNS))
def test_engine_with_tome_matches_jax(engines, inputs, name):
    """6-step DPM++ at CFG 7.5 with ToMe: top-left destinations, or the JAX
    UNet's own (``tome_dst``); and DeepCache x ToMe in chunks of 2."""
    jeng, params, teng = engines
    cfg, interval, microbatch = ENGINE_RUNS[name]
    steps = 6
    jplan, plan = JS.DPMSolverScheduler().build_plan(steps), S.DPMSolverScheduler().build_plan(steps)
    jkw, kw = {}, {"microbatch": microbatch}
    if interval:
        jkw["cache_plan"] = JCachePlan.every(steps, interval, 0)
        kw["cache_plan"] = CachePlan.every(steps, interval, 0)
    want = jeng.sample(params, jplan, *inputs["jax"], jax.random.PRNGKey(0), guidance_scale=7.5,
                       latent_hw=(8, 8), init_latents=jnp.asarray(inputs["lat0"]),
                       tome=_jax_cfg(cfg), microbatch=microbatch, **jkw)
    if cfg.rand:
        kw["tome_dst"] = t(jax_tome_destinations(plan.timesteps, teng.unet.tome_slots(8, 8, cfg)))
    got = teng.sample(plan, *inputs["torch"], guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=t(inputs["lat0"]), tome=cfg, **kw)
    # fp32 over 6 CFG-amplified steps, as the DPM++ engine test.
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)


def test_engine_draws_destinations_per_step(engines, inputs):
    """Without ``tome_dst`` the engine draws each step's destinations from
    (timestep, site, block): passing those draws gives the same bits; the
    ratio 0 turns ToMe off."""
    _, _, teng = engines
    plan = S.DPMSolverScheduler().build_plan(3)
    kw = dict(guidance_scale=7.5, latent_hw=(8, 8), init_latents=t(inputs["lat0"]))
    slots = teng.unet.tome_slots(8, 8, TomeConfig(0.5))
    drawn = torch.stack([tome_destinations(int(ts), slots, TomeConfig(0.5))
                         for ts in plan.timesteps])
    own = teng.sample(plan, *inputs["torch"], tome=0.5, **kw)
    given = teng.sample(plan, *inputs["torch"], tome=0.5, tome_dst=drawn, **kw)
    assert torch.equal(own.images, given.images)
    off = teng.sample(plan, *inputs["torch"], tome=0.0, **kw)
    assert torch.equal(off.images, teng.sample(plan, *inputs["torch"], **kw).images)
    with pytest.raises(ValueError, match="tome_dst"):
        teng.sample(plan, *inputs["torch"], tome=0.5, tome_dst=drawn[:2], **kw)


def test_pipeline_tome_ratio_and_guidance_rescale(monkeypatch):
    """The pipeline's ``tome_ratio`` and ``guidance_rescale`` reach the
    engine; a call's ``tome_ratio`` overrides the attribute."""
    pipe = StableDiffusionModel(tiny=True, dtype="float32", device="cpu")
    seen = []
    real = pipe.engine.sample
    monkeypatch.setattr(pipe.engine, "sample", lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    pipe.tome_ratio, pipe.guidance_rescale = 0.25, 0.7
    pipe(["a cat"], num_inference_steps=2)
    pipe(["a cat"], num_inference_steps=2, tome_ratio=0.5)
    assert [(kw["tome"], kw["guidance_rescale"]) for kw in seen] == [(0.25, 0.7), (0.5, 0.7)]


def test_graphed_tome_variants(monkeypatch):
    """A ToMe config keys its own graph; a None argument (the plain call's
    missing DeepCache features) is part of the signature and stays None."""
    graphs = []

    def capture(self, args):
        graphs.append(object())
        static_in = [None if a is None else a.clone() for a in args]
        return type("G", (), {"replay": lambda s: None})(), static_in, self.fn(*static_in)

    monkeypatch.setattr(GraphedCall, "_capture", capture)

    def fn(x, cache=None, dst=None, tome=None):
        assert cache is None
        return x * (1 if tome is None else tome.ratio) + (0 if dst is None else dst.sum())

    call = GraphedVariants(fn)
    x, dst = torch.ones(2), torch.tensor([1.0, 2.0])
    for _ in range(2):
        for r in (0.25, 0.5):
            assert torch.equal(call(x, None, dst, tome=TomeConfig(r)), x * r + 3)
    assert call.captures == {(("tome", TomeConfig(0.25)),): 1, (("tome", TomeConfig(0.5)),): 1}
