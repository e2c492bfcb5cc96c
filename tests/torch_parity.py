"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs go through the JAX package and the port: numpy arrays made
from a seed, and the same weights, a JAX tree turned into torch state
dicts by the port's name maps.  Everything runs in fp32 on the CPU, one
torch thread (the tests run beside other workers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from sonicdiffusionbayeslab_torch.models.weights import MapEntries, invert

torch.set_num_threads(1)


def randn(shape, seed, scale=1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def random_params(shapes, seed: int):
    """Numpy params for a tree of ``jax.ShapeDtypeStruct``: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), biases and embeddings
    N(0, 0.05^2).  Random biases and scales (not Flax's zeros and ones)
    make a mis-mapped one show."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        v = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return v / np.sqrt(np.prod(s.shape[:-1]))
        return 0.05 * v + (1.0 if name == "scale" else 0.0)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_init(module, seed, *args):
    """Random params for ``module(*args)``; the shapes come from
    ``jax.eval_shape`` (Flax's eager init would dominate a small test)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))
    return random_params(shapes["params"], seed)


@functools.lru_cache(maxsize=None)
def tiny_engines():
    """(JAX tiny engine, its random numpy params, the port's tiny engine on
    the CPU loaded with the same weights), all fp32."""
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
    from sonicdiffusionbayeslab_torch.models.weights import state_dicts_from_jax
    from sonicdiffusionbayeslab_tpu import models as jm

    jeng = jm.StableDiffusionEngine(jm.UNetConfig.tiny(), jm.VAEConfig.tiny(),
                                    jm.CLIPTextConfig.tiny(), dtype=jnp.float32,
                                    param_dtype=jnp.float32)
    params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 0)
    teng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                 dtype=torch.float32, device="cpu")
    teng.load_state_dicts(state_dicts_from_jax(params))
    return jeng, params, teng


@functools.lru_cache(maxsize=None)
def tiny_family_engines(family: str):
    """(JAX tiny engine, its random numpy params, the port's tiny engine on
    the CPU loaded with the same weights), all fp32, for ``family`` "sd21"
    (``UNetConfig.tiny21``, ``CLIPTextConfig.tiny21``) or "sdxl"
    (``UNetConfig.tiny_xl``, ``SDXLTextConfigs.tiny``)."""
    from sonicdiffusionbayeslab_torch.models import sampler as TS
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
    from sonicdiffusionbayeslab_torch.models.weights import state_dicts_from_jax
    from sonicdiffusionbayeslab_tpu import models as jm
    from sonicdiffusionbayeslab_tpu.models import sampler as JS

    kw = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    if family == "sd21":
        jeng = jm.StableDiffusionEngine(jm.UNetConfig.tiny21(), jm.VAEConfig.tiny(),
                                        jm.CLIPTextConfig.tiny21(), **kw)
        teng = TS.StableDiffusionEngine(UNetConfig.tiny21(), VAEConfig.tiny(),
                                        CLIPTextConfig.tiny21(), dtype=torch.float32,
                                        device="cpu")
    else:
        jeng = JS.SDXLEngine(jm.UNetConfig.tiny_xl(), jm.VAEConfig.tiny(),
                             JS.SDXLTextConfigs.tiny(), **kw)
        teng = TS.SDXLEngine(UNetConfig.tiny_xl(), VAEConfig.tiny(), TS.SDXLTextConfigs.tiny(),
                             dtype=torch.float32, device="cpu")
    params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 0)
    teng.load_state_dicts(state_dicts_from_jax(params, teng.unet_config))
    return jeng, params, teng


@functools.lru_cache(maxsize=None)
def tiny_sd3_engines():
    """(JAX tiny SD3 engine, its random numpy params, the port's tiny SD3
    engine on the CPU loaded with the same weights), all fp32."""
    from sonicdiffusionbayeslab_torch.models import mmdit as TM
    from sonicdiffusionbayeslab_torch.models.sampler import SDXLTextConfigs
    from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
    from sonicdiffusionbayeslab_torch.models.weights import state_dicts_from_jax
    from sonicdiffusionbayeslab_tpu.models import mmdit as JM
    from sonicdiffusionbayeslab_tpu.models import sampler as JSam
    from sonicdiffusionbayeslab_tpu.models.sd3 import SD3Engine as JaxSD3Engine
    from sonicdiffusionbayeslab_tpu.models.vae import VAEConfig as JaxVAEConfig

    jeng = JaxSD3Engine(JM.MMDiTConfig.tiny(), JaxVAEConfig.tiny16(), JSam.SDXLTextConfigs.tiny(),
                        dtype=jnp.float32, param_dtype=jnp.float32)
    params = random_params(jax.eval_shape(lambda: jeng.init_params(seed=0, latent_hw=8)), 0)
    teng = SD3Engine(TM.MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                     dtype=torch.float32, device="cpu")
    teng.load_state_dicts(state_dicts_from_jax(params))
    return jeng, params, teng


def load_block(torch_module, flax_params, fill) -> torch.nn.Module:
    """Load one block's Flax params into its torch twin (strict), with the
    entries ``fill(MapEntries, "b", "b")`` writes for it."""
    m = MapEntries()
    fill(m, "b", "b")
    sd = invert({"b": flax_params}, dict(m))
    torch_module.load_state_dict({k[2:]: t(v) for k, v in sd.items()}, strict=True)
    return torch_module.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def assert_close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def jax_step_noise(key, sample_indices, steps, shape) -> np.ndarray:
    """The JAX engine's per-step draws of a noise-injecting plan:
    ``fold_in(key, 0x5EED)`` split once a step, sample ``i``'s noise
    ``normal(fold_in(sub, i))``; [steps, B, *shape]."""
    k = jax.random.fold_in(key, 0x5EED)
    out = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append([np.asarray(jax.random.normal(jax.random.fold_in(sub, int(i)), shape,
                                                 jnp.float32)) for i in sample_indices])
    return np.asarray(out, np.float32)


def jax_tome_destinations(timesteps, slots, sy=2, sx=2) -> np.ndarray:
    """The JAX UNet's ToMe destinations of each step and slot (``slots``
    from the port's ``UNet2DCondition.tome_slots``): the in-cell draws of
    ``fold_in(fold_in(fold_in(PRNGKey(0x703E), t), site), block)``;
    [steps, slots, n_dst] (every slot's map the same size)."""
    from sonicdiffusionbayeslab_tpu.ops.tome import _dst_index_grid

    out = []
    for ts in np.asarray(timesteps, np.float32):
        k = jax.random.fold_in(jax.random.PRNGKey(0x703E), jnp.asarray(ts).astype(jnp.int32))
        out.append([np.asarray(_dst_index_grid(h, w, sy, sx, jax.random.fold_in(
            jax.random.fold_in(k, site), block))) for site, block, h, w in slots])
    return np.asarray(out, np.int64)


def step_lrs(learning_rate, steps, warmup_steps=0):
    """The rate of each step run, lr(c) for c = 0..steps-1: optax's
    warmup schedule as the JAX trainers build it, else the constant."""
    if warmup_steps > 0:
        sched = optax.linear_schedule(0.0, learning_rate, warmup_steps)
        return [float(sched(c)) for c in range(steps)]
    return [learning_rate] * steps


def assert_adam_close(got, want, lrs):
    """Trained tensors of two runs of Adam (tests/test_torch_training.py's
    docstring): every entry within 2·Σ lrs, at most 0.1% beyond 0.1·max
    lrs (``lrs``: the rate of each step run)."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= 2 * sum(lrs), err.max()
    assert (err > 0.1 * max(lrs)).mean() <= 1e-3, (err > 0.1 * max(lrs)).mean()


def fast_flax_init(monkeypatch) -> None:
    """While ``monkeypatch`` is active, JAX modules get random params from
    ``jax.eval_shape`` (``random_params``) in place of Flax's eager
    ``init``, which compiles op by op (a tiny JAX pipeline's takes ~60 s)."""
    from flax import linen as nn

    orig = nn.Module.init

    def init(self, rng, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw), rng, *args)
        return {"params": random_params(shapes["params"], 0)}

    monkeypatch.setattr(nn.Module, "init", init)


# A small T5-shaped tokenizer.json, built by the ``tokenizers`` package
# (what the JAX package's load_t5_tokenizer reads): a Unigram vocab with
# scores (T5's <pad>, </s>, <unk> first, then pieces and <extra_id_*>), a
# Precompiled charsmap encoded by the port's writer (tokenizers must accept
# it), Metaspace and TemplateProcessing's </s>.  ``layout`` "spm" is
# [Precompiled, Replace(" {2,}", " ")] (SD3's tokenizer_3), "converter"
# [Precompiled, Strip(right), Replace(" {2,}", "▁")] (transformers 4.57's
# SpmConverter).
T5_CHARSMAP = {
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},  # full-width A-Z
    **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},  # full-width a-z
    "ﬁ": "fi", "é": "é", "　": " ", "\x07": "", "ｅ": "E",
}


def t5_vocab(seed: int = 0, n: int = 300):
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrst"
    pieces = ["▁"] + [c for c in letters + "éEF"] + ["▁" + c for c in letters + "fé"]
    seen = set(pieces)
    while len(pieces) < n:
        p = "".join(letters[i] for i in rng.integers(0, len(letters), rng.integers(2, 6)))
        p = ("▁" + p) if rng.random() < 0.5 else p
        if p not in seen:
            seen.add(p)
            pieces.append(p)
    scores = -rng.uniform(1.0, 12.0, len(pieces))
    return ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
            + [(p, float(s)) for p, s in zip(pieces, scores)]
            + [(f"<extra_id_{i}>", 0.0) for i in range(3, -1, -1)])


def write_t5_tokenizer_json(directory, layout: str = "spm", scheme: str = "always",
                            seed: int = 0):
    """Write ``directory``/tokenizer.json through ``tokenizers``; its path."""
    from pathlib import Path

    from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers
    from tokenizers import processors

    from sonicdiffusionbayeslab_torch.models.tokenizer import encode_precompiled_charsmap

    vocab = t5_vocab(seed)
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    pre = [normalizers.Precompiled(encode_precompiled_charsmap(T5_CHARSMAP))]
    tok.normalizer = normalizers.Sequence(
        pre + [normalizers.Replace(Regex(" {2,}"), " ")] if layout == "spm" else
        pre + [normalizers.Strip(left=False, right=True),
               normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"], special_tokens=[("</s>", 1)])
    tok.add_special_tokens([AddedToken(p, normalized=False) for p, _ in vocab
                            if p.startswith("<")])
    path = Path(directory) / "tokenizer.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tok.save(str(path))
    return path
