"""IP-Adapter (``models/ip_adapter.py``, the decoupled ``to_k_ip``/``to_v_ip``
cross-attentions) in the port against the JAX package (tiny SD-1.5 and
SDXL configs, fp32, CPU): the processor order against JAX's paths through
the name map, the image projection and the UNet (1e-4 + 1e-4 |ref|), the
engine and the pipeline under CFG with the zero embedding's tokens as the
unconditional half (1e-3), and the checkpoint loader on files written
here (the port's export and the JAX package's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, flax_init, load_block, random_params, randn, t,
                          tiny_engines, tiny_family_engines)
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import ip_adapter as IP
from sonicdiffusionbayeslab_torch.models import sampler as TS
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import (
    StableDiffusion3Model,
    StableDiffusionModel,
)
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import ip_adapter as JIP
from sonicdiffusionbayeslab_tpu.models import pipelines as JP
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.models.unet import UNetConfig as JaxUNetConfig

EMBED = 24
TIME_IDS = np.tile(np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32), (2, 1))


@functools.lru_cache(maxsize=None)
def _engines(fam):
    """(JAX engine, params with a random adapter merged in, the port's
    engine with the same weights): fresh engines of this module's own."""
    jeng, params, teng = (tiny_engines.__wrapped__() if fam == "sd15"
                          else tiny_family_engines.__wrapped__("sdxl"))
    ip = random_params(jax.eval_shape(lambda: jeng.init_ip_params(
        seed=1, latent_hw=8, embed_dim=EMBED, num_tokens=4)), 2)
    params = {**params, "image_proj": ip["image_proj"],
              "unet": JIP.merge_ip_params(params["unet"],
                                          JIP.extract_ip_params(ip["unet"], jeng.unet_config))}
    teng.init_ip_adapter(embed_dim=EMBED, num_tokens=4)
    teng.load_state_dicts(W.state_dicts_from_jax(params, teng.unet_config))
    return jeng, params, teng


@pytest.mark.parametrize("name", ["tiny", "sd15", "tiny_xl", "sdxl"])
def test_processor_order_is_jax_through_the_name_map(name):
    """The port's cross-attention names are the JAX paths' diffusers names,
    in the same (attn_processors) order, at the same odd indices; the UNet's
    own cross-attentions come in that order."""
    cfg, jcfg = getattr(UNetConfig, name)(), getattr(JaxUNetConfig, name)()
    nm = W.unet_name_map(cfg)
    want = [nm[f"{p}/to_q/kernel"][0].removesuffix(".to_q.weight")
            for p in JIP.ip_attn_paths(jcfg)]
    assert IP.ip_attn_paths(cfg) == want
    assert IP.ip_processor_indices(cfg) == JIP.ip_processor_indices(jcfg)
    with torch.device("meta"):
        unet = TS.UNet2DCondition(cfg)
    assert [n for n, _ in unet.cross_attentions()] == want
    if name == "sd15":
        assert len(want) == 16 and IP.ip_processor_indices(cfg)[-1] == 31


def test_image_projection_matches_jax():
    emb = randn((3, EMBED), 1)
    params = flax_init(JIP.ImageProjection(32, 4), 3, emb)
    want = JIP.ImageProjection(32, 4).apply({"params": params}, jnp.asarray(emb))

    def fill(m, dst, src):
        m.dense(f"{dst}/proj", f"{src}.proj")
        m.norm(f"{dst}/norm", f"{src}.norm")

    proj = load_block(IP.ImageProjection(EMBED, 32, 4), params, fill)
    with torch.inference_mode():
        got = proj(t(emb))
    assert got.shape == (3, 4, 32)
    assert_close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("fam", ["sd15", "sdxl"])
def test_unet_with_ip_tokens_matches_jax(fam):
    """The UNet with image-prompt tokens at scale 0.6 within 1e-4 + 1e-4
    |ref|; at scale 0 the port's output is the bare UNet's, bit for bit."""
    jeng, params, teng = _engines(fam)
    x, ts, ctx = randn((2, 8, 8, 4), 1), np.array([801.0, 41.0], np.float32), randn((2, 77, 32), 2)
    tokens = randn((2, 4, 32), 3)
    jadded, added = None, ()
    if fam == "sdxl":
        pooled = randn((2, 16), 4)
        jadded = {"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(TIME_IDS)}
        added = (t(pooled), t(TIME_IDS))
    want = jax.jit(functools.partial(jeng.unet.apply, ip_scale=0.6))(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jadded,
        ip_context=jnp.asarray(tokens))
    args = (t(x), t(ts), t(ctx), None, None, *added)
    args += (None,) * (7 - len(args))
    with torch.inference_mode():
        got = teng.unet(*args, t(tokens), torch.tensor(0.6))
        off = teng.unet(*args, t(tokens), torch.tensor(0.0))
        bare = teng.unet(*args)
    assert_close(got, want, 1e-4, 1e-4)
    assert torch.equal(off, bare)
    assert float((got - bare).abs().max()) > 1e-3


def test_engine_with_ip_adapter_matches_jax():
    """8-step DPM++ (order 2), CFG 7.5, batch 2, scale 0.8, from given
    initial latents: latents and images within 1e-3."""
    jeng, params, teng = _engines("sd15")
    tok = HashTokenizer(vocab_size=1000)
    ids, neg = tok(["a cat", "a dog"]), tok(["", ""])
    lat0, emb = randn((2, 8, 8, 4), 6), randn((2, EMBED), 7)
    want = jeng.sample(params, JS.DPMSolverScheduler().build_plan(8),
                       jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg),
                       jax.random.PRNGKey(0), guidance_scale=7.5, latent_hw=(8, 8),
                       init_latents=jnp.asarray(lat0),
                       ip_adapter={"image_embeds": jnp.asarray(emb), "scale": 0.8})
    got = teng.sample(S.DPMSolverScheduler().build_plan(8), teng.encode_prompts(ids),
                      teng.encode_prompts(neg), guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=t(lat0), ip_adapter={"image_embeds": emb, "scale": 0.8})
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)


def _export(teng, path):
    sd = IP.export_ip_adapter(teng.unet.state_dict(), teng.image_proj.state_dict(),
                              teng.unet_config)
    torch.save(sd, path)
    return sd


def test_checkpoint_round_trip_and_jax_export(tmp_path):
    """The port's export, saved and loaded, gives back the adapter's tensors;
    the JAX package's export of the same adapter loads to the same port
    entries, with the checkpoint's odd processor indices."""
    jeng, params, teng = _engines("sd15")
    sd = _export(teng, tmp_path / "port.bin")
    assert sorted(sd["ip_adapter"]) == sorted(f"{i}.{p}.weight" for i in (1, 3, 5, 7)
                                             for p in ("to_k_ip", "to_v_ip"))
    jsd = JIP.export_ip_adapter(params["unet"], params["image_proj"], jeng.unet_config)
    torch.save({part: {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}
                for part, d in jsd.items()}, tmp_path / "jax.bin")
    mine = teng.unet.state_dict()
    for name in ("port.bin", "jax.bin"):
        loaded = IP.load_ip_adapter(tmp_path / name, teng.unet_config)
        assert loaded["num_tokens"] == 4 and loaded["embed_dim"] == EMBED
        assert loaded["unet_ip"].keys() == IP.extract_ip_params(mine, teng.unet_config).keys()
        for k, v in loaded["unet_ip"].items():
            assert torch.equal(v, mine[k]), k
        for k, v in teng.image_proj.state_dict().items():
            assert torch.equal(loaded["image_proj"][k], v), k
    bad = torch.load(tmp_path / "port.bin", weights_only=True)
    bad["ip_adapter"]["99.to_k_ip.weight"] = bad["ip_adapter"]["1.to_k_ip.weight"]
    torch.save(bad, tmp_path / "bad.bin")
    with pytest.raises(KeyError, match="unmapped"):
        IP.load_ip_adapter(tmp_path / "bad.bin", teng.unet_config)


def test_pipeline_with_ip_adapter_matches_jax(tmp_path, monkeypatch):
    """Both pipelines load one adapter file (``ip_adapter=``) and sample with
    ``ip_image_embeds`` at ``ip_scale`` 0.6 (6-step DPM++, CFG 7.5): images
    within 1e-3, the port's initial latents set to the JAX pipeline's draws;
    a path that does not exist random-initialises a 1024-wide adapter."""
    from sonicdiffusionbayeslab_tpu.utils import rng as jrng

    jeng, params, teng = _engines("sd15")
    _export(teng, tmp_path / "ip.bin")
    base = {k: v for k, v in params.items() if k != "image_proj"}
    saved = JP.StableDiffusionModel._load_params
    JP.StableDiffusionModel._load_params = lambda self, pm, seed: base
    try:
        jpipe = JP.StableDiffusionModel(tiny=True, image_size=64, dtype="float32",
                                        ip_adapter=str(tmp_path / "ip.bin"))
    finally:
        JP.StableDiffusionModel._load_params = saved
    jpipe.engine = jeng
    jpipe.scheduler = JS.DPMSolverScheduler(solver_order=2)
    tpipe = StableDiffusionModel(tiny=True, image_size=64, dtype="float32", device="cpu",
                                 ip_adapter=str(tmp_path / "ip.bin"))
    sds = W.state_dicts_from_jax(params, teng.unet_config)
    tpipe.engine.load_state_dicts(sds)
    assert tpipe.ip_embed_dim == jpipe.ip_embed_dim == EMBED
    key = jax.random.PRNGKey(3)
    lat0 = np.asarray(jrng.per_sample_latents(key, jnp.arange(2), (8, 8, 4)))
    monkeypatch.setattr(TS, "per_sample_latents", lambda *a, **kw: t(lat0))
    emb = randn((2, EMBED), 8)
    kw = dict(num_inference_steps=6, guidance_scale=7.5, ip_image_embeds=emb, ip_scale=0.6)
    want = jpipe(["a cat", "a dog"], key=key, **kw)[0]
    got = tpipe(["a cat", "a dog"], **kw)[0]
    assert_close(got, want, 1e-3)
    with pytest.raises(ValueError, match="embedding dim"):
        tpipe(["a"], num_inference_steps=2, ip_image_embeds=np.zeros((1, 7), np.float32))
    with pytest.raises(ValueError, match="microbatch"):
        tpipe(["a", "b"], num_inference_steps=2, ip_image_embeds=emb, unet_microbatch=2)
    rand = StableDiffusionModel(tiny=True, dtype="float32", device="cpu", ip_adapter="nope.bin")
    assert rand.ip_embed_dim == 1024 and rand.engine.image_proj.num_tokens == 4


def test_refusals():
    plain = StableDiffusionModel(tiny=True, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="without ip_adapter"):
        plain(["a"], num_inference_steps=2, ip_image_embeds=np.zeros((1, 1024), np.float32))
    with pytest.raises(ValueError, match="init_ip_adapter"):
        plain.engine.sample(S.DPMSolverScheduler().build_plan(2), torch.zeros(1, 77, 32), None,
                            latent_hw=(8, 8), ip_adapter={"image_embeds": np.zeros((1, 4))})
    with pytest.raises(NotImplementedError, match="UNet-family"):
        StableDiffusion3Model(tiny=True, dtype="float32", device="cpu", ip_adapter="x.bin")
    with pytest.raises(ValueError, match="init_ip_adapter first"):
        plain.engine.load_state_dicts({**{k: m.state_dict() for k, m in
                                          zip(plain.engine.MODULES, plain.engine.modules())},
                                       "image_proj": {}})
