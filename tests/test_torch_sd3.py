"""SD3 (``stable_diffusion_3_model``) in the port against the JAX package
(tiny configs, fp32, CPU, JAX trees from ``jax.eval_shape``): the sincos
table, the MMDiT blocks and the MMDiT with trunk-delta caching and
DiT-ToMe on the JAX package's destination grids, its loud errors, the T5
encoder, its buckets and hash ids, the SD3 weight round trip, the 16-channel
VAE, ``SD3Engine`` and ``StableDiffusion3Model`` under CFG (CLIP-only, with
T5 resident and staged, microbatch, trunk-delta, ToMe), int8 runs against
the JAX engine's quantization drift, and the pipeline's refusals."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, flax_init, random_params, randn, t, write_t5_tokenizer_json
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import mmdit as TM
from sonicdiffusionbayeslab_torch.models import t5 as TT
from sonicdiffusionbayeslab_torch.models import tokenizer as TTok
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import (
    StableDiffusion3Model,
    StableDiffusion3ModelTwoSchedulers,
)
from sonicdiffusionbayeslab_torch.models.sampler import CachePlan, SDXLTextConfigs
from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import mmdit as JM
from sonicdiffusionbayeslab_tpu.models import sampler as JSam
from sonicdiffusionbayeslab_tpu.models import t5 as JT
from sonicdiffusionbayeslab_tpu.models import tokenizer as JTok
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.models.sd3 import SD3Engine as JaxSD3Engine
from sonicdiffusionbayeslab_tpu.models.vae import VAEConfig as JaxVAEConfig
from sonicdiffusionbayeslab_tpu.ops import quant as JQ
from sonicdiffusionbayeslab_tpu.ops import tome as JTome

TOL = (1e-4, 1e-4)  # modules: |port - jax| <= 1e-4 + 1e-4 * |jax|
TIME = np.array([100.25, 733.5], np.float32)  # flow timesteps are floats


def _jcfg(cfg):
    return JM.MMDiTConfig(**dataclasses.asdict(cfg))


def _tensors(sd):
    return {k: t(v) for k, v in sd.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_mmdit_destinations(timesteps, depth, hp, wp, sy=2, sx=2):
    """The JAX MMDiT's DiT-ToMe destinations: block i of the step at
    timestep t draws from ``fold_in(fold_in(PRNGKey(0x703E), int32(t)),
    i)``; [steps, depth, n_dst]."""
    out = []
    for ts in np.asarray(timesteps, np.float32):
        k = jax.random.fold_in(jax.random.PRNGKey(0x703E), jnp.asarray(ts).astype(jnp.int32))
        out.append([np.asarray(JTome._dst_index_grid(hp, wp, sy, sx, jax.random.fold_in(k, i)))
                    for i in range(depth)])
    return np.asarray(out, np.int64)


# -------------------------------------------------------------- sincos table
@pytest.mark.parametrize("dim,grid,base", [(16, 24, 4), (64, 192, 64), (1536, 24, 8)])
def test_sincos_table_bit_equal_to_jax(dim, grid, base):
    np.testing.assert_array_equal(TM.sincos_pos_embed_2d(dim, grid, base),
                                  JM.sincos_pos_embed_2d(dim, grid, base))


def test_cropped_table_bit_equal_to_jax():
    """The center crop at the tiny grid and at SD3-medium's 1024^2 and
    512^2 grids of its 192 x 192 table (hidden narrowed to 64)."""
    mid = dataclasses.replace(TM.MMDiTConfig.sd3_medium(), num_heads=1)
    for cfg, grids in ((TM.MMDiTConfig.tiny(), ((4, 4), (3, 5), (24, 24))),
                       (mid, ((64, 64), (32, 32), (48, 80)))):
        for h, w in grids:
            np.testing.assert_array_equal(TM.cropped_pos_embed(cfg, h, w),
                                          JM.cropped_pos_embed(_jcfg(cfg), h, w))
    with pytest.raises(ValueError, match="pos_embed_max_size"):
        TM.cropped_pos_embed(TM.MMDiTConfig.tiny(), 25, 4)


# ------------------------------------------------------------------ blocks
def _block_map(cfg, i):
    """The name map of block i alone (JAX paths and torch names relative to
    the block)."""
    jp, tp = f"blocks_{i}/", f"transformer_blocks.{i}."
    return {k[len(jp):]: (v[0][len(tp):], v[1]) for k, v in W.mmdit_name_map(cfg).items()
            if k.startswith(jp)}


@pytest.mark.parametrize("pre_only,qk_norm", [(False, False), (True, False), (False, True)])
def test_mmdit_block_matches_jax(pre_only, qk_norm):
    """One joint block, plain and context_pre_only (the final block: a
    (scale, shift) context norm, no context output), and with q/k norms."""
    cfg = dataclasses.replace(TM.MMDiTConfig.tiny(), qk_norm=qk_norm)
    img, ctx, c = randn((2, 16, 16), 1), randn((2, 7, 16), 2), randn((2, 16), 3)
    jblk = JM.MMDiTBlock(_jcfg(cfg), context_pre_only=pre_only)
    p = flax_init(jblk, 4, img, ctx, c)
    blk = TM.MMDiTBlock(cfg, pre_only).eval()
    blk.load_state_dict(_tensors(W.invert(p, _block_map(cfg, cfg.depth - 1 if pre_only else 0))),
                        strict=True)
    jimg, jctx = jblk.apply({"params": p}, *map(jnp.asarray, (img, ctx, c)))
    with torch.no_grad():
        timg, tctx = blk(t(img), t(ctx), t(c))
    assert_close(timg, jimg, *TOL)
    if pre_only:
        assert tctx is None and jctx is None
    else:
        assert_close(tctx, jctx, *TOL)


# ------------------------------------------------------------------ MMDiT
@pytest.fixture(scope="module")
def mmdit():
    """(config, JAX module, numpy params, the port's MMDiT loaded with them,
    inputs: latents [2, 8, 8, 16], float timesteps, context [2, 7, 40],
    pooled [2, 32])."""
    cfg = TM.MMDiTConfig.tiny()
    jmod = JM.MMDiT(_jcfg(cfg))
    lat, ctx, pooled = randn((2, 8, 8, 16), 5), randn((2, 7, 40), 6), randn((2, 32), 7)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(lat),
                            jnp.asarray(TIME), jnp.asarray(ctx),
                            {"text_embeds": jnp.asarray(pooled)})
    params = random_params(shapes["params"], 8)
    tmod = TM.MMDiT(cfg).eval()
    tmod.load_state_dict(_tensors(W.invert(params, W.mmdit_name_map(cfg))), strict=True)
    return cfg, jmod, params, tmod, (lat, TIME, ctx, pooled)


def _jax_apply(jmod, params, inputs, **kw):
    lat, ts, ctx, pooled = inputs
    return jmod.apply({"params": params}, jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                      {"text_embeds": jnp.asarray(pooled)}, **kw)


def _port_apply(tmod, inputs, cache=None, dst=None, **kw):
    lat, ts, ctx, pooled = inputs
    with torch.no_grad():
        return tmod(t(lat), t(ts), t(ctx), cache, dst, t(pooled), torch.zeros(2, 6), **kw)


def test_mmdit_matches_jax(mmdit):
    cfg, jmod, params, tmod, inputs = mmdit
    got = _port_apply(tmod, inputs)
    assert got.shape == (2, 8, 8, 16) and got.dtype == torch.float32
    assert_close(got, _jax_apply(jmod, params, inputs), *TOL)


@pytest.mark.parametrize("branch", [0, 1])
def test_mmdit_trunk_delta_record_and_replay_match_jax(mmdit, branch):
    """The full call's output and trunk delta, and a cached call replaying
    the JAX package's delta."""
    cfg, jmod, params, tmod, inputs = mmdit
    jout, jdelta = _jax_apply(jmod, params, inputs, return_cache=True, cache_branch_id=branch)
    out, delta = _port_apply(tmod, inputs, return_cache=True, cache_branch_id=branch)
    assert tuple(delta.shape) == (2,) + tmod.cache_shape(8, 8, branch) == (2, 16, 16)
    assert_close(out, jout, *TOL)
    assert_close(delta, jdelta, *TOL)
    want = _jax_apply(jmod, params, inputs, cache=jdelta, cache_branch_id=branch)
    got = _port_apply(tmod, inputs, cache=t(np.array(jdelta)), cache_branch_id=branch)
    assert_close(got, want, *TOL)


@pytest.mark.parametrize("share", [True, False])
def test_mmdit_tome_on_jax_destinations_matches_jax(mmdit, share):
    """DiT-ToMe at ratio 0.5 with the JAX MMDiT's per-block destinations
    passed as ``tome_dst``, alone and with the trunk-delta cache (record at
    branch 1, replay)."""
    cfg, jmod, params, tmod, inputs = mmdit
    jcfg, tcfg = JTome.TomeConfig(0.5, share=share), TomeConfig(0.5, share=share)
    dst = t(jax_mmdit_destinations(TIME[:1], cfg.depth, 4, 4)[0]).long()
    assert tmod.tome_slots(8, 8, tcfg) == [(0, 0, 4, 4), (1, 0, 4, 4)]
    assert tmod.tome_slots(8, 8, tcfg, 1) == [(0, 0, 4, 4)]
    want = _jax_apply(jmod, params, inputs, tome=jcfg)
    got = _port_apply(tmod, inputs, dst=dst, tome=tcfg)
    assert_close(got, want, *TOL)
    assert not np.allclose(got.numpy(), np.asarray(_jax_apply(jmod, params, inputs)), atol=1e-3)
    jout, jdelta = _jax_apply(jmod, params, inputs, tome=jcfg, return_cache=True,
                              cache_branch_id=1)
    out, delta = _port_apply(tmod, inputs, dst=dst, tome=tcfg, return_cache=True,
                             cache_branch_id=1)
    assert_close(out, jout, *TOL)
    assert_close(delta, jdelta, *TOL)
    want = _jax_apply(jmod, params, inputs, tome=jcfg, cache=jdelta, cache_branch_id=1)
    got = _port_apply(tmod, inputs, cache=t(jdelta), dst=dst[:1], tome=tcfg, cache_branch_id=1)
    assert_close(got, want, *TOL)


def test_mmdit_tome_skips_an_untiled_grid(mmdit):
    """Cells that do not tile the 4 x 4 patch grid: no slots, and the call
    is the exact one bit for bit, as in the JAX package."""
    cfg, jmod, params, tmod, inputs = mmdit
    tcfg = TomeConfig(0.5, sy=3, sx=3)
    assert tmod.tome_slots(8, 8, tcfg) == []
    assert torch.equal(_port_apply(tmod, inputs, dst=torch.zeros(0, 0, dtype=torch.long),
                                   tome=tcfg), _port_apply(tmod, inputs))


def test_mmdit_loud_errors(mmdit):
    cfg, jmod, params, tmod, inputs = mmdit
    lat, ts, ctx, pooled = map(t, inputs)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="w-embedding"):
            tmod(lat, ts, ctx, text_embeds=pooled, timestep_cond=torch.zeros(2, 4))
        with pytest.raises(ValueError, match="text_embeds"):
            tmod(lat, ts, ctx)
        with pytest.raises(ValueError, match="joint_attention_dim"):
            tmod(lat, ts, ctx[..., :8], text_embeds=pooled)
        with pytest.raises(ValueError, match="out of range"):
            tmod(lat, ts, ctx, text_embeds=pooled, return_cache=True, cache_branch_id=cfg.depth)
        with pytest.raises(ValueError, match="exclusive"):
            tmod(lat, ts, ctx, torch.zeros(2, 16, 16), text_embeds=pooled, return_cache=True)
        with pytest.raises(ValueError, match="not divisible"):
            tmod(lat[:, :7], ts, ctx, text_embeds=pooled)
        with pytest.raises(ValueError, match="tome_dst"):
            tmod(lat, ts, ctx, text_embeds=pooled, tome=TomeConfig(0.5))


def _shape_paths(tree, prefix=""):
    """(path, shape) of each leaf of a tree of ``jax.ShapeDtypeStruct``."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _shape_paths(v, path)
        else:
            yield path, tuple(v.shape)


def test_mmdit_full_geometry_names_every_port_parameter():
    """SD3-medium's geometry (depth 24, 24 x 64 heads, joint dim 4096): the
    JAX MMDiT's parameter paths, mapped by the port's name map, are exactly
    the port's state-dict names and shapes; the same for T5-XXL's encoder."""
    cfg = TM.MMDiTConfig.sd3_medium()
    shapes = jax.eval_shape(JM.MMDiT(_jcfg(cfg)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 16)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, 4096)), {"text_embeds": jnp.zeros((1, 2048))})
    tcfg = TT.T5Config.xxl()
    t5_shapes = jax.eval_shape(JT.T5Encoder(JT.T5Config.xxl()).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 256), jnp.int32))
    with torch.device("meta"):
        port = {"mmdit": TM.MMDiT(cfg).state_dict(), "t5": TT.T5Encoder(tcfg).state_dict()}
    for key, tree, nm in (("mmdit", shapes["params"], W.mmdit_name_map(cfg)),
                          ("t5", t5_shapes["params"], W.t5_name_map(tcfg.num_layers))):
        leaves = dict(_shape_paths(tree))
        names = {nm[p][0]: p for p in leaves}
        assert set(names) == set(port[key]), key
        for name, path in names.items():
            got = tuple(port[key][name].shape)
            if path == "patch_proj/kernel":
                assert got == (1536, 16, 2, 2) and leaves[path] == (64, 1536)
            elif path.endswith("kernel"):
                assert got == leaves[path][::-1], name
            else:
                assert got == leaves[path], name
    n = sum(v.numel() for v in port["mmdit"].values())
    assert 2.0e9 < n < 2.1e9, n


# --------------------------------------------------------------------- T5
@pytest.mark.parametrize("T,nb,md", [(16, 8, 16), (77, 32, 128), (256, 32, 128), (300, 32, 128)])
def test_relative_buckets_bit_equal_to_jax(T, nb, md):
    got = TT.relative_position_buckets(T, T, num_buckets=nb, max_distance=md)
    want = JT.relative_position_buckets(T, T, num_buckets=nb, max_distance=md)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_t5_encoder_matches_jax():
    cfg = TT.T5Config.tiny()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, cfg.max_length)).astype(np.int32)
    jmod = JT.T5Encoder(JT.T5Config.tiny())
    p = flax_init(jmod, 9, ids)
    tmod = TT.T5Encoder(cfg).eval()
    tmod.load_state_dict(_tensors(W.invert(p, W.t5_name_map(cfg.num_layers))), strict=True)
    want = jmod.apply({"params": p}, jnp.asarray(ids))["last_hidden_state"]
    with torch.no_grad():
        got = tmod(torch.as_tensor(ids, dtype=torch.long))
    assert got.dtype == torch.float32
    assert_close(got, want, *TOL)


def test_t5_hash_ids_equal_jax_and_tokenizer_json_refused(tmp_path):
    prompts = ["A photograph of an astronaut riding a horse", "", "x " * 300]
    for vocab, length in ((32128, 256), (1000, 16)):
        np.testing.assert_array_equal(TTok.load_t5_tokenizer(None, vocab, length)(prompts),
                                      JTok.load_t5_tokenizer(None, vocab, length)(prompts))
    np.testing.assert_array_equal(TTok.load_t5_tokenizer(str(tmp_path))(prompts),
                                  JTok.load_t5_tokenizer(str(tmp_path))(prompts))
    # A snapshot's tokenizer.json: the port's reader gives the JAX package's
    # ids (tests/test_torch_t5_tokenizer.py holds it over both layouts); a
    # file it cannot read raises, never hashes.
    write_t5_tokenizer_json(tmp_path)
    for length in (256, 16):
        got = TTok.load_t5_tokenizer(str(tmp_path), 32128, length)(prompts)
        assert got[0, 0] != 0 and got.shape == (3, length)
        np.testing.assert_array_equal(got,
                                      JTok.load_t5_tokenizer(str(tmp_path), 32128, length)(prompts))
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError, match="model None is not read"):
        TTok.load_t5_tokenizer(str(tmp_path))


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    """(JAX tiny SD3 engine with T5, its random numpy params, the port's
    engine on the CPU loaded with them), fp32."""
    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    jeng = JaxSD3Engine(JM.MMDiTConfig.tiny(), JaxVAEConfig.tiny16(), JSam.SDXLTextConfigs.tiny(),
                        t5_config=JT.T5Config.tiny(), **kw)
    params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 0)
    teng = SD3Engine(TM.MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                     t5_config=TT.T5Config.tiny(), dtype=torch.float32, device="cpu")
    teng.load_state_dicts(W.state_dicts_from_jax(params))
    return jeng, params, teng


def test_sd3_state_dicts_equal_jax_invert(engines):
    """The MMDiT (patch kernel as an OIHW conv), VAE, both towers with
    their projections and T5, by the JAX package's own name maps; the
    engine loads them strictly (the fixture)."""
    jeng, params, teng = engines
    sds = W.state_dicts_from_jax(params)
    assert set(sds) == {"unet", "vae", "text", "text2", "t5"} == set(teng.MODULES)
    want = {"unet": JW.invert(params["unet"], JW.mmdit_name_map(jeng.unet_config)),
            "t5": JW.invert(params["t5"], JW.t5_name_map(2)),
            "text": JW.invert(params["text"], JW.clip_text_name_map(2)),
            "text2": JW.invert(params["text2"], JW.clip_text_name_map(2))}
    want["text"]["text_projection.weight"] = np.asarray(params["text_proj"]["kernel"]).T
    want["text2"]["text_projection.weight"] = np.asarray(params["text2_proj"]["kernel"]).T
    for key, sd in want.items():
        assert sds[key].keys() == sd.keys(), key
        for name, v in sd.items():
            np.testing.assert_array_equal(sds[key][name].numpy(), v, err_msg=name)
    assert not any(k.startswith("post_quant_conv") or k.startswith("quant_conv")
                   for k in sds["vae"])


def test_sd3_snapshot_round_trip_loads_strictly(engines, tmp_path):
    """``write_snapshot`` writes the diffusers SD3 layout (``transformer/``,
    ``text_encoder_3/``); with the keys a real snapshot adds (the sincos
    buffer, T5's tied embedding, position ids) ``load_sd3_checkpoint`` loads
    it back strictly, and a missing key raises naming the file."""
    jeng, params, teng = engines
    root = W.write_snapshot(teng, tmp_path / "sd3")
    assert sorted(p.name for p in root.iterdir()) == [
        "text_encoder", "text_encoder_2", "text_encoder_3", "transformer", "vae"]
    extra = {"transformer": {"pos_embed.pos_embed": torch.zeros(1, 576, 16)},
             "text_encoder_3": {"encoder.embed_tokens.weight": torch.zeros(1000, 40)},
             "text_encoder": {"text_model.embeddings.position_ids": torch.arange(77)[None]}}
    for sub, keys in extra.items():
        f = next((root / sub).iterdir())
        torch.save({**torch.load(f, weights_only=True), **keys}, f)
    # T5 in transformers' sharded layout: two files and their index.
    f = root / "text_encoder_3" / "pytorch_model.bin"
    sd, names = torch.load(f, weights_only=True), {}
    for i, part in enumerate((dict(list(sd.items())[:5]), dict(list(sd.items())[5:]))):
        torch.save(part, root / "text_encoder_3" / f"pytorch_model-0000{i + 1}-of-00002.bin")
        names.update({k: f"pytorch_model-0000{i + 1}-of-00002.bin" for k in part})
    (root / "text_encoder_3" / "pytorch_model.bin.index.json").write_text(
        json.dumps({"weight_map": names}))
    f.unlink()
    other = SD3Engine(TM.MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                      t5_config=TT.T5Config.tiny(), dtype=torch.float32, device="cpu")
    W.load_sd3_checkpoint(root, other)
    for a, b in zip(teng.modules(), other.modules()):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    f = root / "transformer" / "diffusion_pytorch_model.bin"
    sd = torch.load(f, weights_only=True)
    del sd["proj_out.bias"]
    torch.save(sd, f)
    with pytest.raises(RuntimeError, match="transformer"):
        W.load_sd3_checkpoint(root, other)


def test_vae16_decode_and_shifted_encode_match_jax(engines):
    """SD3's VAE contract on the tiny16 geometry: decode of scaled latents
    ((z / 1.5305 + 0.0609), no post-quant conv) and the posterior sample
    ``(mean + exp(logvar / 2) noise - 0.0609) * 1.5305``."""
    jeng, params, teng = engines
    z, img = randn((2, 8, 8, 16), 11), randn((2, 16, 16, 3), 12)
    noise = randn((2, 8, 8, 16), 13)
    want = jeng.vae.apply({"params": params["vae"]}, jnp.asarray(z), method=jeng.vae.decode)
    with torch.no_grad():
        assert_close(teng.vae.decode(t(z)), want, *TOL)
        got = teng.vae.encode_sample(t(img), t(noise))
    mean, logvar = jeng.vae.apply({"params": params["vae"]}, jnp.asarray(img),
                                  method=jeng.vae.encode)
    cfg = teng.vae_config
    want = (np.asarray(mean) + np.exp(0.5 * np.asarray(logvar)) * noise
            - cfg.shift_factor) * cfg.scaling_factor
    assert (cfg.latent_channels, cfg.scaling_factor, cfg.shift_factor, cfg.use_quant_conv) == (
        16, 1.5305, 0.0609, False) and VAEConfig.sd3().latent_channels == 16
    assert_close(got, want, *TOL)


def _ids(eng, prompts, t5=True):
    toks = [JTok.HashTokenizer(c.vocab_size, c.max_length)(prompts)
            for c in (eng.text_config, eng.text2_config)]
    if t5:
        toks.append(JTok.HashTokenizer(eng.t5_config.vocab_size, eng.t5_config.max_length)(prompts))
    return toks


@pytest.mark.parametrize("use_t5", [False, True])
def test_encode_prompts_sd3_matches_jax(engines, use_t5):
    """Context [B, 77 (+ 16), 40] (CLIP states side by side, zero-padded to
    the joint width; T5's states after them) and pooled [B, 32] (both
    projected pooled outputs)."""
    jeng, params, teng = engines
    ids = _ids(teng, ["a cat", "an astronaut riding a horse"], use_t5)
    jctx, jpooled = jeng.encode_prompts_sd3(params, *ids)
    ctx, pooled = teng.encode_prompts_sd3(*ids)
    assert tuple(ctx.shape) == (2, 77 + 16 * use_t5, 40) and tuple(pooled.shape) == (2, 32)
    assert torch.equal(ctx[:, :77, 32:], torch.zeros(2, 77, 8))
    assert_close(ctx, jctx, *TOL)
    assert_close(pooled, jpooled, *TOL)
    if not use_t5:
        with pytest.raises(ValueError, match="use_t5"):
            SD3Engine(TM.MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                      dtype=torch.float32, device="cpu").encode_prompts_sd3(*_ids(teng, ["a"]))


def test_t5_width_guard():
    with pytest.raises(ValueError, match="joint_attention_dim"):
        SD3Engine(TM.MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                  t5_config=TT.T5Config(d_model=64), dtype=torch.float32, device="cpu")


ENGINE_CASES = {
    "clip": dict(),
    "t5": dict(t5=True),
    "microbatch": dict(microbatch=2),
    "trunk_delta": dict(cache=(2, 1)),
    "trunk_delta_microbatch": dict(cache=(2, 1), microbatch=2),
    "tome": dict(tome=0.5),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_under_cfg_matches_jax(engines, case):
    """4-step flow Euler (shift 3) at CFG 5 from the same latents:
    CLIP-only, with T5, microbatch 2, the trunk-delta cache (interval 2,
    branch 1, also in chunks) and DiT-ToMe 0.5 on the JAX destinations;
    images within 1e-3."""
    jeng, params, teng = engines
    c = ENGINE_CASES[case]
    prompts = ["a cat", "a red boat"]
    ids, nids = _ids(teng, prompts, c.get("t5")), _ids(teng, ["", ""], c.get("t5"))
    jctx, jpooled = jeng.encode_prompts_sd3(params, *ids)
    jnctx, jnpooled = jeng.encode_prompts_sd3(params, *nids)
    ctx, pooled = teng.encode_prompts_sd3(*ids)
    nctx, npooled = teng.encode_prompts_sd3(*nids)
    lat0 = randn((2, 8, 8, 16), 21)
    jplan, plan = JS.FlowMatchEulerScheduler(shift=3.0).build_plan(4), \
        S.FlowMatchEulerScheduler(shift=3.0).build_plan(4)
    jkw = dict(guidance_scale=5.0, latent_hw=(8, 8), init_latents=jnp.asarray(lat0),
               added_cond={"text_embeds": jpooled, "negative_text_embeds": jnpooled,
                           "time_ids": jnp.zeros((2, 6))})
    kw = dict(guidance_scale=5.0, latent_hw=(8, 8), init_latents=t(lat0),
              added_cond={"text_embeds": pooled, "negative_text_embeds": npooled,
                          "time_ids": torch.zeros(2, 6)})
    if "microbatch" in c:
        jkw["microbatch"] = kw["microbatch"] = c["microbatch"]
    if "cache" in c:
        jkw["cache_plan"] = JSam.CachePlan.every(4, *c["cache"])
        kw["cache_plan"] = CachePlan.every(4, *c["cache"])
    if "tome" in c:
        jkw["tome"] = JTome.TomeConfig(c["tome"])
        kw["tome"] = TomeConfig(c["tome"])
        kw["tome_dst"] = t(jax_mmdit_destinations(plan.timesteps, 2, 4, 4)).long()
    want = jeng.sample(params, jplan, jctx, jnctx, jax.random.PRNGKey(0), **jkw)
    got = teng.sample(plan, ctx, nctx, **kw)
    assert got.images.shape == (2, 16, 16, 3) and got.nfe == 4
    assert_close(got.images, want.images, 1e-3)
    assert_close(got.latents, want.latents, 1e-3)


def test_engine_int8_tracks_jax_drift(engines):
    """4-step flow Euler at CFG 5 from given latents under int8 against the
    JAX engine under int8 and both exact runs.  An activation near an int8
    rounding boundary may round the other way under the two fp32
    implementations' ulp-level differences, so the quantized runs are held
    by their drift from the exact run: the port's within 10% of the JAX
    engine's, and nearer the JAX quantized run than that is to its exact
    one (as ``tests/test_torch_quant.py`` holds the UNet).  ``int8_conv_only``
    has no conv to hit in the MMDiT: exact bits."""
    jeng, params, teng = engines
    ids, nids = _ids(teng, ["a boat", "a cat"], False), _ids(teng, ["", ""], False)
    jctx, jpooled = jeng.encode_prompts_sd3(params, *ids)
    jnctx, jnpooled = jeng.encode_prompts_sd3(params, *nids)
    ctx, pooled = teng.encode_prompts_sd3(*ids)
    nctx, npooled = teng.encode_prompts_sd3(*nids)
    lat0 = randn((2, 8, 8, 16), 22)
    jplan, plan = JS.FlowMatchEulerScheduler().build_plan(4), S.FlowMatchEulerScheduler().build_plan(4)
    jkw = dict(guidance_scale=5.0, latent_hw=(8, 8), init_latents=jnp.asarray(lat0), decode=False,
               added_cond={"text_embeds": jpooled, "negative_text_embeds": jnpooled,
                           "time_ids": jnp.zeros((2, 6))})
    kw = dict(guidance_scale=5.0, latent_hw=(8, 8), init_latents=t(lat0), decode=False,
              added_cond={"text_embeds": pooled, "negative_text_embeds": npooled,
                          "time_ids": torch.zeros(2, 6)})
    runs = {}
    try:
        for m in ("int8", None):
            JQ.set_quant_mode(m)
            runs[("jax", m)] = np.asarray(jeng.sample(params, jplan, jctx, jnctx,
                                                      jax.random.PRNGKey(0), **jkw).latents)
            JQ.set_quant_mode(None)
            teng.set_quant_mode(m)
            runs[("port", m)] = teng.sample(plan, ctx, nctx, **kw).latents.numpy()
        teng.set_quant_mode("int8_conv_only")
        conv_only = teng.sample(plan, ctx, nctx, **kw).latents.numpy()
    finally:
        JQ.set_quant_mode(None)
        teng.set_quant_mode(None)
    rel = lambda a, b: float(np.linalg.norm(runs[a] - runs[b]) / np.linalg.norm(runs[b]))  # noqa: E731
    assert_close(runs[("port", None)], runs[("jax", None)], 1e-3)
    drift, jax_drift = rel(("port", "int8"), ("port", None)), rel(("jax", "int8"), ("jax", None))
    assert 0.0 < drift and abs(drift - jax_drift) <= 0.1 * jax_drift, (drift, jax_drift)
    assert rel(("port", "int8"), ("jax", "int8")) < jax_drift
    np.testing.assert_array_equal(conv_only, runs[("port", None)])


def test_mmdit_int8_call_sites(monkeypatch):
    """Under int8 the MMDiT's quantized projections are the JAX package's
    ``projection_dense`` sites: the patch embedding (as a dense), 6 q/k/v,
    2 output and 4 feed-forward projections a block (the final block 1 and
    2), and proj_out; the AdaLN linears, the embedders and
    context_embedder stay exact."""
    from sonicdiffusionbayeslab_torch.ops import quant as Q

    cfg = TM.MMDiTConfig.tiny()
    mod = TM.MMDiT(cfg).eval()
    seen = []
    orig = Q.int8_dense

    def rec(x, weight, *a, **kw):
        seen.append(tuple(weight.shape))
        return orig(x, weight, *a, **kw)

    monkeypatch.setattr(Q, "int8_dense", rec)
    Q.set_quant_mode(mod, "int8")
    with torch.no_grad():
        mod(torch.zeros(1, 8, 8, 16), torch.ones(1), torch.zeros(1, 3, 40),
            text_embeds=torch.zeros(1, 32))
    h = cfg.hidden_size
    per_block = 6 + 2 + 2 + 2  # q/k/v x 2, to_out + to_add_out, ff + ff_context
    assert len(seen) == 1 + per_block + (per_block - 3) + 1
    assert seen[0] == (h, 64) and seen[-1] == (64, h)
    seen.clear()
    Q.set_quant_mode(mod, "int8_conv_only")
    with torch.no_grad():
        mod(torch.zeros(1, 8, 8, 16), torch.ones(1), torch.zeros(1, 3, 40),
            text_embeds=torch.zeros(1, 32))
    assert seen == []


# --------------------------------------------------------------- pipeline
@pytest.fixture
def fast_flax_init(monkeypatch):
    """JAX modules get random params from ``jax.eval_shape`` (Flax's eager
    init would dominate a small test); the port loads the same weights."""
    from flax import linen as nn

    orig = nn.Module.init

    def init(self, rng, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw), rng, *args)
        return {"params": random_params(shapes["params"], 0)}

    monkeypatch.setattr(nn.Module, "init", init)


def _with_latents(engine, monkeypatch, lat0, convert):
    sample = engine.sample

    def given(*a, **kw):
        kw["init_latents"] = convert(lat0)
        return sample(*a, **kw)

    monkeypatch.setattr(engine, "sample", given)


@pytest.mark.parametrize("t5", ["off", "resident", "staged"])
def test_pipeline_under_cfg_matches_jax(fast_flax_init, monkeypatch, t5):
    """``StableDiffusion3Model`` against the JAX pipeline on its weights, 3
    flow Euler steps at CFG 5 from the same latents: CLIP-only, and with T5
    resident and staged (the staged copy is gone after the call)."""
    from sonicdiffusionbayeslab_tpu.registry import load_all_plugins, models_registry

    load_all_plugins()
    use_t5 = t5 != "off"
    jpipe = models_registry["stable_diffusion_3_model"](
        pretrained_model="x", tiny=True, image_size=64, dtype="float32", use_t5=use_t5,
        t5_staged=False)
    pipe = StableDiffusion3Model(tiny=True, dtype="float32", device="cpu", use_t5=use_t5,
                                 t5_staged=t5 == "staged")
    pipe.engine.load_state_dicts(W.state_dicts_from_jax(_np_tree(jpipe.params)))
    assert pipe.t5_staged == (t5 == "staged")
    lat0 = randn((2, 8, 8, 16), 31)
    _with_latents(jpipe.engine, monkeypatch, lat0, jnp.asarray)
    _with_latents(pipe.engine, monkeypatch, lat0, t)
    jpipe.scheduler = JS.FlowMatchEulerScheduler(shift=3.0)
    pipe.scheduler = S.FlowMatchEulerScheduler(shift=3.0)
    kw = dict(num_inference_steps=3, guidance_scale=5.0)
    want, _, _ = jpipe(["a cat", "a dog"], **kw)
    got, secs, _ = pipe(["a cat", "a dog"], **kw)
    assert got.shape == (2, 16, 16, 3) and secs > 0 and pipe.num_timesteps == 3
    assert_close(got, np.asarray(want), 1e-3)
    assert pipe._t5_dev is None and pipe._pooled_queue == []


def test_pipeline_staged_equals_resident_and_defaults():
    """Staged and resident T5 give the same images from one seed; "auto"
    keeps the tiny model resident; the pipeline's time_ids are zeros."""
    runs = {}
    for staged in (False, True):
        pipe = StableDiffusion3Model(tiny=True, dtype="float32", device="cpu", use_t5=True,
                                     t5_staged=staged, seed=7)
        pipe.scheduler = S.FlowMatchEulerScheduler()
        runs[staged] = pipe(["a cat"], num_inference_steps=2, guidance_scale=5.0)[0]
    np.testing.assert_array_equal(runs[False], runs[True])
    auto = StableDiffusion3Model(tiny=True, dtype="float32", device="cpu", use_t5=True)
    assert not auto.t5_staged and auto.tokenizer3.max_length == 16
    auto._pooled_queue.append(torch.ones(3, 32))
    added = auto._extra_sample_kwargs(3, (8, 8))["added_cond"]
    assert torch.equal(added["time_ids"], torch.zeros(3, 6))


def test_pipeline_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="prompt weighting"):
        StableDiffusion3Model(tiny=True, device="cpu", prompt_weighting=True)
    with pytest.raises(NotImplementedError, match="IP-Adapter"):
        StableDiffusion3Model(tiny=True, device="cpu", ip_adapter="foo.bin")
    with pytest.raises(ValueError, match="t5_staged"):
        StableDiffusion3Model(tiny=True, device="cpu", use_t5=True, t5_staged="maybe")
    (tmp_path / "tokenizer_3").mkdir()
    (tmp_path / "tokenizer_3" / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError, match="is not read"):
        StableDiffusion3Model(pretrained_model=str(tmp_path), tiny=True, device="cpu",
                              use_t5=True)
    pipe = StableDiffusion3ModelTwoSchedulers(tiny=True, dtype="float32", device="cpu")
    pipe.scheduler_first = S.FlowMatchEulerScheduler()
    pipe.scheduler_second = S.DPMSolverScheduler()
    with pytest.raises(ValueError, match="space"):
        pipe(["a cat"], num_inference_steps=4, num_step_switch=2)
