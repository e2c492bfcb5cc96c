"""Fused q/k/v projections in the port (``fused_qkv``; the JAX package's
``SDBL_FUSED_QKV=1`` trees) against the JAX package and against the
port's own separate projections (tiny configs, fp32, CPU).

The JAX engine and ControlNet are built and initialised with
``SDBL_FUSED_QKV=1`` set, so their trees hold ``to_qkv``/``to_kv``
kernels, and the port's fused modules load them through the name maps.
Held to JAX: the engine's 3-step DPM++ run at CFG 7.5 (images and latents
within 1e-4, the UNet's, the fused VAE decoder's and the fused ControlNet's
outputs within 1e-4 + 1e-4 |ref|) and a LoRA merged into the fused rows
(1e-6).  Held to the port's separate projections: the UNet, ControlNet and
VAE with the same weights concatenated (``weights.fuse_projections``)
within 1e-5 of their largest output; int8 projections bit-equal (the same
per-row scales, exact int32 sums).  And: the attention gets strided views
that the kernels' 16-byte copies can load at every SD width; checkpoints
load into fused modules, but not into a fused VAE, as in the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, random_params, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine, init_module
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.ops.flash_attention import layout_error
from sonicdiffusionbayeslab_torch.ops.quant import set_quant_mode
from sonicdiffusionbayeslab_tpu import models as jm
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import weights as JW

TINY = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny())


def _fused_port_engine(**kw):
    return StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu", fused_qkv=True, **kw)


@pytest.fixture(scope="module")
def fused():
    """(JAX engine, its fused tree and fused ControlNet tree, initialised
    under SDBL_FUSED_QKV=1, the port's fused engine loaded with both).
    Each test that traces a JAX call sets the variable for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDBL_FUSED_QKV", "1")
        jeng = jm.StableDiffusionEngine(jm.UNetConfig.tiny(), jm.VAEConfig.tiny(),
                                        jm.CLIPTextConfig.tiny(), dtype=jnp.float32,
                                        param_dtype=jnp.float32)
        params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 1)
        cn = random_params(jax.eval_shape(lambda: jeng.init_controlnet_params(seed=0,
                                                                              latent_hw=8)), 3)
    teng = _fused_port_engine()
    teng.load_state_dicts(W.state_dicts_from_jax(params))
    teng.init_controlnet()
    teng.controlnet.load_state_dict(W.controlnet_state_dict_from_jax(cn, teng.unet_config),
                                    strict=True)
    return jeng, params, cn, teng


@functools.lru_cache(maxsize=None)
def _separate_and_fused():
    """A tiny port engine with separate projections (``tiny_engines``'
    weights, a random ControlNet added) and a fused engine loaded with the
    same weights concatenated."""
    sep = StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu")
    sep.load_state_dicts(W.state_dicts_from_jax(tiny_engines()[1]))
    init_module(sep.init_controlnet(), torch.Generator().manual_seed(4))  # heads not zero
    fus = _fused_port_engine()
    fus.init_controlnet()
    for name in ("unet", "vae", "text", "controlnet"):
        mine = getattr(fus, name)
        mine.load_state_dict(W.fuse_projections(getattr(sep, name).state_dict(), mine),
                             strict=True)
    return sep, fus


def test_fused_trees_carry_every_port_parameter(fused):
    """The JAX fused trees' paths through the port's maps are exactly the
    fused modules' parameters (the strict loads above): a to_qkv and a
    to_kv in every transformer block of the UNet, no separate to_k or
    to_v, a to_qkv in each VAE mid attention."""
    _, params, cn, teng = fused
    names = teng.unet.state_dict()
    n_qkv = sum(k.endswith("attn1.to_qkv.weight") for k in names)
    n_kv = sum(k.endswith("attn2.to_kv.weight") for k in names)
    assert n_qkv == n_kv == len([k for k in names if k.endswith("attn2.to_q.weight")]) > 0
    assert not any(k.endswith(("to_k.weight", "to_v.weight")) for k in names)
    vae = teng.vae.state_dict()
    assert {k for k in vae if "to_qkv" in k} == {"decoder.mid_block.attentions.0.to_qkv.weight",
                                                 "encoder.mid_block.attentions.0.to_qkv.weight"}
    flat = W.flatten(params["unet"])
    assert any(p.endswith("attn1/to_qkv/kernel") for p in flat)
    assert any(p.endswith("attn2/to_kv/kernel") for p in W.flatten(cn))


def test_fused_engine_matches_jax(fused, monkeypatch):
    """3-step DPM++ (order 2) at CFG 7.5 through the fused UNet and the
    fused VAE decoder: the JAX engine's run (SDBL_FUSED_QKV=1) and the
    port's with the same tree, initial latents and plan rows."""
    from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

    monkeypatch.setenv("SDBL_FUSED_QKV", "1")
    jeng, params, _, teng = fused
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    lat0 = randn((2, 8, 8, 4), 6)
    want = jeng.sample(params, JS.DPMSolverScheduler(solver_order=2).build_plan(3),
                       jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg_ids),
                       jax.random.PRNGKey(0), guidance_scale=7.5, latent_hw=(8, 8),
                       init_latents=jnp.asarray(lat0))
    got = teng.sample(S.DPMSolverScheduler(solver_order=2).build_plan(3),
                      teng.encode_prompts(ids), teng.encode_prompts(neg_ids),
                      guidance_scale=7.5, latent_hw=(8, 8), init_latents=t(lat0))
    top = float(np.abs(np.asarray(want.latents)).max())
    assert_close(got.latents, want.latents, 1e-4 * top)
    assert_close(got.images, want.images, 1e-4)


def test_fused_unet_and_vae_decoder_match_jax(fused, monkeypatch):
    monkeypatch.setenv("SDBL_FUSED_QKV", "1")
    jeng, params, _, teng = fused
    x, ts, ctx = randn((2, 8, 8, 4), 1), np.array([901.0, 21.0], np.float32), randn((2, 77, 32), 2)
    want = jax.jit(jeng.unet.apply)({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                                    jnp.asarray(ctx))
    want_img = jeng.decode_fn(params["vae"], jnp.asarray(x))
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx))
        got_img = teng.decode(t(x))
    assert_close(got, want, 1e-4, 1e-4)
    assert_close(got_img, want_img, 1e-4, 1e-4)


def test_fused_controlnet_matches_jax(fused, monkeypatch):
    monkeypatch.setenv("SDBL_FUSED_QKV", "1")
    jeng, _, cn, teng = fused
    x, ts, ctx = randn((2, 8, 8, 4), 3), np.array([501.0, 41.0], np.float32), randn((2, 77, 32), 4)
    cond = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    want_down, want_mid = jax.jit(jeng.controlnet.apply)(
        {"params": cn}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(cond), 0.7,
        None)
    with torch.inference_mode():
        down, mid = teng.controlnet(t(x), t(ts), t(ctx), t(cond), torch.tensor(0.7))
    for g, w in zip((*down, mid), (*want_down, want_mid)):
        assert_close(g, w, 1e-4, 1e-4)


@pytest.mark.parametrize("module", ["unet", "controlnet", "vae_decode", "vae_encode"])
def test_fused_modules_match_separate_ones(module):
    """The same weights, separate and concatenated: within 1e-5 of the
    separate module's largest output."""
    sep, fus = _separate_and_fused()
    x, ts, ctx = randn((2, 8, 8, 4), 7), np.array([700.0, 3.0], np.float32), randn((2, 77, 32), 8)
    cond = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    img = np.random.default_rng(10).random((2, 64, 64, 3)).astype(np.float32)

    def run(eng):
        with torch.inference_mode():
            if module == "unet":
                return eng.unet(t(x), t(ts), t(ctx))
            if module == "controlnet":
                return torch.cat([r.flatten() for r in (*eng.controlnet(
                    t(x), t(ts), t(ctx), t(cond), torch.tensor(1.0)),)
                    for r in (r if isinstance(r, tuple) else (r,))])
            if module == "vae_decode":
                return eng.decode(t(x))
            return eng.vae.encode(t(img) * 2 - 1)[0]

    want, got = run(sep), run(fus)
    assert float(want.abs().max()) > 1e-2
    assert_close(got, want, 1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("layout", ["peft", "kohya"])
def test_merge_lora_into_fused_rows_matches_jax(fused, layout):
    """A LoRA on to_q, to_k and to_v (and to_out) of every attention: the
    JAX package adds each into its columns of the fused kernel, the port
    into its rows of the fused weight; a to_k LoRA lands in rows
    [inner:2 inner] of to_qkv."""
    jeng, params, _, teng = fused
    base = teng.unet.state_dict()
    rng = np.random.default_rng(11)
    lora = {}
    for name, w in base.items():
        parent, _, proj = name.removesuffix(".weight").rpartition(".")
        srcs = W.FUSED_SOURCES.get(proj, ())
        for src in srcs:
            mod, out = f"{parent}.{src}", w.shape[0] // len(srcs)
            down = rng.standard_normal((2, w.shape[1])).astype(np.float32)
            up = 0.1 * rng.standard_normal((out, 2)).astype(np.float32)
            if layout == "peft":
                lora[f"unet.{mod}.lora_A.weight"], lora[f"unet.{mod}.lora_B.weight"] = down, up
                lora[f"unet.{mod}.alpha"] = np.float32(2.0)
            else:
                key = "lora_unet_" + mod.replace(".", "_")
                lora[f"{key}.lora_down.weight"], lora[f"{key}.lora_up.weight"] = down, up
    want_tree = JW.merge_lora(params["unet"], lora, JW.unet_name_map(jeng.unet_config), 0.8)
    want = W.state_dicts_from_jax({**params, "unet": want_tree})["unet"]
    got, merged = W.merge_lora(base, {k: torch.as_tensor(v) for k, v in lora.items()}, 0.8)
    assert len(merged) == sum(1 for k in lora if k.endswith(("lora_A.weight", "lora_down.weight")))
    for k, v in want.items():
        assert_close(got[k], v, 1e-6)
    qkv = next(k for k in base if k.endswith("attn1.to_qkv.weight"))
    inner = base[qkv].shape[0] // 3
    mod = qkv.removesuffix(".to_qkv.weight")
    if layout == "peft":
        down = torch.as_tensor(lora[f"unet.{mod}.to_k.lora_A.weight"])
        up = torch.as_tensor(lora[f"unet.{mod}.to_k.lora_B.weight"])
        delta = got[qkv] - base[qkv]
        assert_close(delta[inner:2 * inner], up @ down * 0.8, 1e-6)


def test_lora_step_on_fused_projections_matches_jax(fused, monkeypatch):
    """LoRA adapters on ``to_qkv`` and ``to_kv`` (the default targets name
    them, in both packages): one train step's loss and every adapter's
    gradient against the JAX trainer's on its fused tree, as
    ``tests/test_torch_training.py`` holds the separate ones."""
    from test_torch_training import STEP_TOL, _jax_lora_loss, jax_draws, np_tree

    from sonicdiffusionbayeslab_torch.training import lora as TL
    from sonicdiffusionbayeslab_torch.training import trainer as TT
    from sonicdiffusionbayeslab_tpu.training import lora as JL
    from sonicdiffusionbayeslab_tpu.training import trainer as JT

    monkeypatch.setenv("SDBL_FUSED_QKV", "1")
    jeng, params, _, teng = fused
    lat, ctx = randn((2, 8, 8, 4), 15), randn((2, 77, 32), 16)
    cfg_kw = dict(lora_rank=4, snr_gamma=5.0)
    adapters = np_tree(JL.init_lora(params["unet"], 4, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(17)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "b" else v, adapters)
    tsteps, noise = jax_draws(0, lat.shape)
    want_loss, want_grads = _jax_lora_loss(jeng, params, JT.TrainConfig(**cfg_kw),
                                           jnp.asarray(lat), jnp.asarray(ctx),
                                           jnp.asarray(tsteps), jnp.asarray(noise))(
        jax.tree.map(jnp.asarray, adapters))
    want = {f"{m}/{k}": v for m, ab in W.lora_from_jax(np_tree(want_grads),
                                                        UNetConfig.tiny()).items()
            for k, v in ab.items()}
    trainer = TT.DiffusionTrainer(teng, TT.TrainConfig(**cfg_kw))
    state = trainer.init_state(adapters=W.lora_from_jax(adapters, UNetConfig.tiny()))
    assert set(state.trainable) == set(TL.lora_targets(teng.unet))
    assert any(k.endswith("to_qkv") for k in state.trainable)
    loss, grads = trainer.value_and_grad(state, t(lat), t(ctx), noise=t(noise),
                                         timesteps=torch.from_numpy(tsteps))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert_close(g, want[k].numpy(), *STEP_TOL)


def test_fused_int8_is_bit_equal_to_separate_int8():
    """Under int8 the fused projection is one quantized GEMM whose per-row
    activation scales and per-output-channel weight scales are the
    separate ones': q, k and v bit-equal, and so the attention outputs."""
    torch.manual_seed(0)
    for ctx_dim in (None, 24):
        sep = L.Attention(32, 2, 16, context_dim=ctx_dim)
        fus = L.Attention(32, 2, 16, context_dim=ctx_dim, fused_qkv=True)
        torch.nn.init.normal_(sep.to_q.weight)
        torch.nn.init.normal_(sep.to_k.weight)
        torch.nn.init.normal_(sep.to_v.weight)
        fus.load_state_dict(W.fuse_projections(sep.state_dict(), fus), strict=True)
        for m in (sep, fus):
            set_quant_mode(m, "int8")
        x, c = randn((2, 16, 32), 12), randn((2, 5, 24), 13)
        ctx = None if ctx_dim is None else t(c)
        with torch.no_grad():
            for a, b in zip(sep._qkv(t(x), ctx), fus._qkv(t(x), ctx)):
                assert torch.equal(a, b)
            assert torch.equal(sep(t(x), ctx), fus(t(x), ctx))


def test_fused_views_reach_the_attention_without_a_copy(monkeypatch):
    """q, k and v of a fused projection go to ``dot_product_attention`` as
    strided views of its one output, and at every SD-1.5 / SD-2.x / SDXL
    attention width in bf16 (inner 320-1280, head_dim 40 or 64) their
    pointers and strides pass the kernels' 16-byte-copy check."""
    seen = []

    def record(q, k, v, mask=None):
        seen.append((q, k, v))
        return torch.zeros_like(q)

    monkeypatch.setattr(L, "dot_product_attention", record)
    attn = L.Attention(32, 2, 16, fused_qkv=True)
    with torch.no_grad():
        attn(t(randn((2, 16, 32), 14)))
    q, k, v = seen[0]
    assert q.untyped_storage().data_ptr() == k.untyped_storage().data_ptr() == \
        v.untyped_storage().data_ptr()
    assert q.stride() == (16 * 96, 96, 16, 1)
    for heads, head_dim in ((8, 40), (8, 80), (8, 160), (5, 64), (10, 64), (20, 64)):
        inner = heads * head_dim
        for sections in (3, 2):
            out = torch.empty(2, 64, sections * inner, dtype=torch.bfloat16)
            for view in out.split(inner, dim=-1):
                assert layout_error(view.view(2, 64, heads, head_dim)) is None, (heads, head_dim)


def test_checkpoints_load_into_fused_modules_but_not_a_fused_vae(tmp_path):
    """A diffusers snapshot (separate projections): into a fused engine the
    UNet loads concatenated, and then the VAE raises KeyError, as the JAX
    package's conversion of such a snapshot fails at its VAE; a ControlNet
    checkpoint loads into a fused ControlNet."""
    sep, _ = _separate_and_fused()
    root = W.write_snapshot(sep, tmp_path / "snap")
    eng = _fused_port_engine()
    with pytest.raises(KeyError, match="fused q/k/v"):
        W.load_sd_checkpoint(root, eng)
    want = W.fuse_projections(sep.unet.state_dict(), eng.unet)
    for k, v in eng.unet.state_dict().items():
        assert torch.equal(v, want[k]), k
    (tmp_path / "cn").mkdir()
    torch.save(sep.controlnet.state_dict(), tmp_path / "cn" / "diffusion_pytorch_model.bin")
    eng.init_controlnet()
    W.load_controlnet_checkpoint(tmp_path / "cn", eng)
    want = W.fuse_projections(sep.controlnet.state_dict(), eng.controlnet)
    for k, v in eng.controlnet.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fused_flag_follows_the_variable(monkeypatch):
    """``fused_qkv`` None takes ``SDBL_FUSED_QKV`` (only "1" fuses, as the
    JAX package reads it); an explicit False beats it."""
    monkeypatch.setenv("SDBL_FUSED_QKV", "1")
    assert _fused_port_engine().fused_qkv
    assert StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu").unet.fused_qkv
    assert not StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu",
                                     fused_qkv=False).vae.fused_qkv
    monkeypatch.setenv("SDBL_FUSED_QKV", "true")
    assert not StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu").fused_qkv
