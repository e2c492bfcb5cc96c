"""SDXL (``stable_diffusion_xl_model``) in the port against the JAX package
(tiny configs, fp32, CPU): the UNet with depth and heads a level and the
text_time conditioning, both text towers and ``encode_prompts_xl``, the
engine under CFG with the negative pooled embedding, the pipeline's
time_ids and second tokenizer, a diffusers snapshot loaded strictly,
DeepCache and Token Merging on the SDXL UNet, and
``configs/sdxl_config.yaml`` through the port's CLI."""

import csv
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_methods import COMMON, _jax_points
from torch_parity import (assert_close, jax_tome_destinations, randn, t,
                          tiny_family_engines)
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import registry as R
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionXLModel
from sonicdiffusionbayeslab_torch.models.sampler import SDXLEngine, SDXLTextConfigs
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
from sonicdiffusionbayeslab_tpu import registry as JR
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.models.pipelines import StableDiffusionXLModel as JaxXLPipeline
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.ops.tome import TomeConfig as JaxTomeConfig

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "sdxl_config.yaml")


@pytest.fixture(scope="module")
def engines():
    return tiny_family_engines("sdxl")


def _added(seed, batch=2, pooled=16):
    return randn((batch, pooled), seed), np.tile(
        np.array([[64.0, 48.0, 0.0, 0.0, 64.0, 48.0]], np.float32), (batch, 1))


def test_state_dicts_equal_jax_invert(engines):
    """UNet (linear projections, add_embedding, depth a level), VAE, both
    towers and the bigG projection as ``text2``'s ``text_projection``; the
    tree's own geometry suffices for SDXL."""
    jeng, params, teng = engines
    sds = W.state_dicts_from_jax(params)
    geo = W.unet_geometry(params["unet"])
    assert geo.linear_projection and geo.transformer_depth == (1, 2)
    want = {
        "unet": JW.invert(params["unet"], JW.unet_name_map(jeng.unet_config)),
        "text": JW.invert(params["text"], JW.clip_text_name_map(2)),
        "text2": JW.invert(params["text2"], JW.clip_text_name_map(2)),
    }
    want["text2"]["text_projection.weight"] = np.asarray(params["text2_proj"]["kernel"]).T
    assert set(sds) == {"unet", "vae", "text", "text2"}
    for key, sd in want.items():
        assert sds[key].keys() == sd.keys(), key
        for name, v in sd.items():
            np.testing.assert_array_equal(sds[key][name].numpy(), v, err_msg=name)


def test_sdxl_unet_map_names_every_port_parameter():
    """Full SDXL geometry: the JAX UNet's parameter paths, mapped by the
    port's name map, are exactly the port's state-dict names and shapes
    (3 levels, depth (1, 2, 10), the mid block at depth 10, add_embedding
    2816 -> 1280)."""
    from sonicdiffusionbayeslab_tpu.models.unet import UNet2DCondition as JaxUNet
    from sonicdiffusionbayeslab_tpu.models.unet import UNetConfig as JaxConfig

    added = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, 6))}
    shapes = jax.eval_shape(JaxUNet(JaxConfig.sdxl()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, 2048)), added)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    cfg = UNetConfig.sdxl()
    mapped = {k: v.shape for k, v in W.invert(tree, W.unet_name_map(cfg)).items()}
    assert mapped == {k: v.shape for k, v in
                      W.invert(tree, W.unet_name_map(W.unet_geometry(tree))).items()}
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    assert mapped == {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert len(unet.mid_block.attentions[0].transformer_blocks) == 10
    assert unet.add_embedding.linear_1.weight.shape == (1280, 2816)


def test_unet_with_added_cond_matches_jax(engines):
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 21.0], np.float32)
    text_embeds, time_ids = _added(3)
    want = jax.jit(jeng.unet.apply)({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                                   jnp.asarray(ctx), {"text_embeds": jnp.asarray(text_embeds),
                                                      "time_ids": jnp.asarray(time_ids)})
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx), None, None, t(text_embeds), t(time_ids))
        with pytest.raises(ValueError, match="added conditioning"):
            teng.unet(t(x), t(ts), t(ctx))
    assert_close(got, want, 1e-4, 1e-4)  # fp32 through ~25 convs/matmuls


def test_text_towers_match_jax(engines):
    """The bigG-shaped tower's three outputs, and ``encode_prompts_xl``:
    both towers' penultimate states side by side, the projected pooled
    embedding."""
    jeng, params, teng = engines
    rng = np.random.default_rng(0)
    ids1, ids2 = (rng.integers(0, 1000, (2, 77)).astype(np.int32) for _ in range(2))
    want = jax.jit(jeng.text2.apply)({"params": params["text2"]}, jnp.asarray(ids2))
    with torch.inference_mode():
        got = teng.text2.outputs(torch.as_tensor(ids2, dtype=torch.long))
    for k in want:
        assert_close(got[k], want[k], 1e-5)
    want_ctx, want_pooled = jeng.encode_prompts_xl(params, ids1, ids2)
    ctx, pooled = teng.encode_prompts_xl(ids1, ids2)
    assert ctx.shape == (2, 77, 32) and pooled.shape == (2, 16)
    assert_close(ctx, want_ctx, 1e-5)
    assert_close(pooled, want_pooled, 1e-5)


@pytest.fixture(scope="module")
def cfg_run(engines):
    """The JAX engine's 10-step DPM++ CFG 7.5 run from given initial
    latents, the negative prompt's pooled embedding as the unconditional
    half's."""
    jeng, params, teng = engines
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    lat0 = randn((2, 8, 8, 4), 5)
    ctx, pooled = jeng.encode_prompts_xl(params, ids, ids)
    nctx, npooled = jeng.encode_prompts_xl(params, neg_ids, neg_ids)
    time_ids = _added(0)[1]
    plan = JS.DPMSolverScheduler().build_plan(10)
    out = jeng.sample(params, plan, ctx, nctx, jax.random.PRNGKey(0), guidance_scale=7.5,
                      latent_hw=(8, 8), init_latents=jnp.asarray(lat0),
                      added_cond={"text_embeds": pooled, "negative_text_embeds": npooled,
                                  "time_ids": jnp.asarray(time_ids)})
    return dict(ids=ids, neg_ids=neg_ids, lat0=lat0, time_ids=time_ids, out=out)


@pytest.mark.parametrize("microbatch", [None, 2])
def test_engine_sample_matches_jax(engines, cfg_run, microbatch):
    _, _, teng = engines
    ctx, pooled = teng.encode_prompts_xl(cfg_run["ids"], cfg_run["ids"])
    nctx, npooled = teng.encode_prompts_xl(cfg_run["neg_ids"], cfg_run["neg_ids"])
    got = teng.sample(S.DPMSolverScheduler().build_plan(10), ctx, nctx, guidance_scale=7.5,
                      latent_hw=(8, 8), init_latents=t(cfg_run["lat0"]), microbatch=microbatch,
                      added_cond={"text_embeds": pooled, "negative_text_embeds": npooled,
                                  "time_ids": t(cfg_run["time_ids"])})
    # fp32 through 10 CFG-amplified UNet calls, as the SD-1.5 engine test.
    assert_close(got.latents, cfg_run["out"].latents, 1e-3)
    assert_close(got.images, cfg_run["out"].images, 1e-3)


def test_time_ids_follow_height_and_width(monkeypatch):
    """The pipeline's added conditioning: (h, w, 0, 0, h, w) of the call's
    latent grid, the prompts' pooled embeddings, then the negative
    prompts', as the JAX pipeline builds it."""
    pos, neg = torch.randn(2, 16), torch.randn(2, 16)
    for lat_hw in ((8, 8), (10, 6)):
        got = StableDiffusionXLModel._extra_sample_kwargs(
            types.SimpleNamespace(_pooled_queue=[pos, neg]), 2, lat_hw)["added_cond"]
        want = JaxXLPipeline._extra_sample_kwargs(
            types.SimpleNamespace(_pooled_queue=[pos.numpy(), neg.numpy()]), 2,
            lat_hw)["added_cond"]
        assert_close(got["time_ids"], want["time_ids"], 0.0)
        assert got["text_embeds"] is pos and got["negative_text_embeds"] is neg
    pipe = StableDiffusionXLModel(tiny=True, dtype="float32", device="cpu")
    seen = []
    sample = pipe.engine.sample

    def recording_sample(*a, **kw):
        seen.append(kw["added_cond"])
        return sample(*a, **kw)

    monkeypatch.setattr(pipe.engine, "sample", recording_sample)
    imgs, _, _ = pipe(["a cat", "a dog"], num_inference_steps=2, height=80, width=48)
    assert imgs.shape == (2, 80 // 4, 48 // 4, 3)  # the tiny VAE upsamples 2x
    (added,) = seen
    assert added["time_ids"].tolist() == [[80.0, 48.0, 0.0, 0.0, 80.0, 48.0]] * 2
    eng = pipe.engine
    _, npooled = eng.encode_prompts_xl(pipe.tokenizer(["", ""]), pipe.tokenizer2(["", ""]))
    assert torch.equal(added["negative_text_embeds"], npooled)
    assert pipe._pooled_queue == []


def test_tokenizers_ids_equal_jax():
    """Both tokenizers of the pipeline give the JAX pipeline's ids."""
    pipe = StableDiffusionXLModel(tiny=True, dtype="float32", device="cpu")
    cfgs = SDXLTextConfigs.tiny()
    prompts = ["a photograph of an astronaut riding a horse", ""]
    for tok, tc in ((pipe.tokenizer, cfgs.text1), (pipe.tokenizer2, cfgs.text2)):
        np.testing.assert_array_equal(tok(prompts), HashTokenizer(tc.vocab_size,
                                                                  tc.max_length)(prompts))


def test_snapshot_loads_strictly(tmp_path):
    """A diffusers SDXL snapshot written with torch.save (the port's own
    tiny modules' tensors, the VAE's encoder side included, plus the keys a
    real snapshot carries that the port drops by name): every module loads
    strictly, and a missing key raises."""
    src = SDXLEngine(UNetConfig.tiny_xl(), VAEConfig.tiny(), SDXLTextConfigs.tiny(),
                     dtype=torch.float32, device="cpu").init_params(7)
    extra = {"text_encoder": {"text_model.embeddings.position_ids": torch.arange(77)[None]},
             "text_encoder_2": {"text_model.embeddings.position_ids": torch.arange(77)[None]}}
    for sub, module in zip(("unet", "vae", "text_encoder", "text_encoder_2"), src.modules()):
        (tmp_path / sub).mkdir()
        name = "pytorch_model.bin" if sub.startswith("text") else "diffusion_pytorch_model.bin"
        torch.save({**module.state_dict(), **extra.get(sub, {})}, tmp_path / sub / name)
    pipe = StableDiffusionXLModel(str(tmp_path), tiny=True, dtype="float32", device="cpu")
    for a, b in zip(src.modules(), pipe.engine.modules()):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    sd = torch.load(tmp_path / "text_encoder_2" / "pytorch_model.bin")
    del sd["text_projection.weight"]
    torch.save(sd, tmp_path / "text_encoder_2" / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="text_projection"):
        StableDiffusionXLModel(str(tmp_path), tiny=True, dtype="float32", device="cpu")


@pytest.mark.parametrize("branch", [0, 1])
def test_deep_cache_on_the_sdxl_unet_matches_jax(engines, branch):
    """DeepCache's split on an SDXL UNet: a full call's output and trunk
    features, and a cached call's output, with the added conditioning."""
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 21.0], np.float32)
    text_embeds, time_ids = _added(4)
    cache = randn((2,) + teng.unet.cache_shape(8, 8, branch), 3)
    assert teng.unet.cache_shape(8, 8, branch) == jeng.unet.cache_shape(8, 8, branch)
    apply = jax.jit(jeng.unet.apply, static_argnames=("return_cache", "cache_branch_id"))
    args = ({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
            {"text_embeds": jnp.asarray(text_embeds), "time_ids": jnp.asarray(time_ids)})
    want_out, want_cache = apply(*args, return_cache=True, cache_branch_id=branch)
    want_cached = apply(*args, cache=jnp.asarray(cache), cache_branch_id=branch)
    added = (t(text_embeds), t(time_ids))
    with torch.inference_mode():
        out, feats = teng.unet(t(x), t(ts), t(ctx), None, None, *added, return_cache=True,
                               cache_branch_id=branch)
        cached = teng.unet(t(x), t(ts), t(ctx), t(cache), None, *added, cache_branch_id=branch)
    assert_close(out, want_out, 1e-4, 1e-4)
    assert_close(feats, want_cache, 1e-4, 1e-4)
    assert_close(cached, want_cached, 1e-4, 1e-4)


def test_tome_on_the_sdxl_unet_matches_jax(engines):
    """Token Merging on an SDXL UNet at max_downsample 2 (the 4 x 4 level:
    a transformer of depth 2 down, the mid block's, two up), with the JAX
    UNet's destinations of each site and block; at SDXL's default
    max_downsample 1 its first level has no transformer, so no slot."""
    jeng, params, teng = engines
    cfg = TomeConfig(0.5, max_downsample=2, share=False)
    slots = teng.unet.tome_slots(8, 8, cfg)
    assert slots == [(s, b, 4, 4) for s in range(4) for b in range(2)]
    assert teng.unet.tome_slots(8, 8, TomeConfig()) == []
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 901.0], np.float32)
    text_embeds, time_ids = _added(5)
    jcfg = JaxTomeConfig(ratio=0.5, max_downsample=2, share=False)
    want = jax.jit(jeng.unet.apply, static_argnames=("tome",))(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        {"text_embeds": jnp.asarray(text_embeds), "time_ids": jnp.asarray(time_ids)}, tome=jcfg)
    dst = torch.as_tensor(jax_tome_destinations([901.0], slots)[0])
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx), None, dst, t(text_embeds), t(time_ids), tome=cfg)
    assert_close(got, want, 1e-4, 1e-4)


def test_sdxl_is_ported_with_the_jax_arguments():
    R.load_all_plugins()
    JR.load_all_plugins()
    assert R.models_registry["stable_diffusion_xl_model"] is StableDiffusionXLModel
    spec = {k: (s.required, repr(s.default)) for k, s in
            R.models_registry.arg_specs("stable_diffusion_xl_model").items() if k != "device"}
    want = {k: (s.required, repr(s.default)) for k, s in
            JR.models_registry.arg_specs("stable_diffusion_xl_model").items() if k in spec}
    assert spec == want and {"pretrained_model", "image_size", "tiny", "dtype"} <= set(spec)


def test_sdxl_config_through_the_cli(tmp_path, monkeypatch, capsys):
    """configs/sdxl_config.yaml at tiny size, 64x64, one sweep point: the
    JAX method's label and nfe, the table and the PNGs."""
    overrides = {**COMMON, "experiment_params.num_inference_steps": [3], "logger.run_id": "run"}
    want = _jax_points(CONFIG, overrides)
    monkeypatch.chdir(tmp_path)
    metrics = cli.run(CONFIG, overrides, device="cpu")
    assert "run dir: outputs/run" in capsys.readouterr().out
    with open(tmp_path / "outputs" / "run" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert [(r["exp"], int(r["nfe"])) for r in rows] == want == [("steps_3", 3)]
    assert metrics["exp"] == ["steps_3"] and 0.0 <= float(rows[0]["clip_score"]) <= 100.0
    assert len(list((tmp_path / "outputs").glob("*/steps_3/*.png"))) == 2


def test_graph_replays_take_new_added_conditioning(engines, monkeypatch):
    """The pooled embeddings and time_ids reach a graphed SDXL UNet call as
    tensor arguments: one variant, one capture, and a replay with other
    embeddings gives the eager output for them (a graph whose replay runs
    the call again on its static inputs stands in for a CUDA graph)."""
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall, GraphedVariants

    class Graph:
        def __init__(self, fn, static_in, static_out):
            self.fn, self.static_in, self.static_out = fn, static_in, static_out

        def replay(self):
            self.static_out.copy_(self.fn(*self.static_in))

    def capture(self, args):
        static_in = [None if a is None else a.clone() for a in args]
        out = self.fn(*static_in)
        return Graph(self.fn, static_in, out), static_in, out

    monkeypatch.setattr(GraphedCall, "_capture", capture)
    _, _, teng = engines
    call = GraphedVariants(teng.unet)
    x, ctx = t(randn((2, 8, 8, 4), 1)), t(randn((2, 77, 32), 2))
    ts = torch.tensor([901.0, 21.0])
    with torch.inference_mode():
        for seed in (6, 7):
            text_embeds, time_ids = (t(a) for a in _added(seed))
            got = call(x, ts, ctx, None, None, text_embeds, time_ids)
            assert torch.equal(got, teng.unet(x, ts, ctx, None, None, text_embeds, time_ids))
    assert call.captures == {(): 1}
