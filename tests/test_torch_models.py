"""The port's CLIP text tower, UNet, VAE decoder, weight maps and
tokenizers against the JAX package (tiny configs, fp32, CPU).

The weights cross through ``state_dicts_from_jax`` and load with
``strict=True`` (``torch_parity.tiny_engines``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.tokenizer import HashTokenizer, load_tokenizer
from sonicdiffusionbayeslab_tpu.models import weights as JW


@pytest.fixture(scope="module")
def engines():
    return tiny_engines()


def test_state_dicts_equal_jax_invert(engines):
    jeng, params, _ = engines
    sds = W.state_dicts_from_jax(params)
    want = {
        "unet": JW.invert(params["unet"], JW.unet_name_map(jeng.unet_config)),
        "vae": JW.invert(params["vae"], JW.vae_name_map(2, 1)),
        "text": JW.invert(params["text"], JW.clip_text_name_map(2)),
    }
    for key in ("unet", "vae", "text"):
        assert sds[key].keys() == want[key].keys(), key
        for name, v in want[key].items():
            np.testing.assert_array_equal(sds[key][name].numpy(), v, err_msg=name)


def test_sd15_unet_map_names_every_port_parameter():
    """Full SD-1.5 geometry: the JAX UNet's parameter paths, mapped by the
    port's name map, are exactly the port's state-dict names and shapes."""
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
    from sonicdiffusionbayeslab_tpu.models.unet import UNet2DCondition as JaxUNet
    from sonicdiffusionbayeslab_tpu.models.unet import UNetConfig as JaxConfig

    shapes = jax.eval_shape(JaxUNet(JaxConfig.sd15()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 768)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    assert W.unet_geometry(tree) == UNetConfig.sd15()
    mapped = {k: v.shape for k, v in W.invert(tree, W.unet_name_map(UNetConfig.sd15())).items()}
    with torch.device("meta"):
        port = {k: tuple(v.shape) for k, v in UNet2DCondition(UNetConfig.sd15()).state_dict().items()}
    assert mapped == port


def test_clip_text_matches_jax(engines):
    jeng, params, teng = engines
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77)).astype(np.int32)
    want = jeng.encode_prompts(params, ids)
    got = teng.encode_prompts(ids)
    # fp32; LayerNorm-normalised O(1) states after two layers.
    assert_close(got, want, 2e-5)


def test_unet_forward_matches_jax(engines):
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 21.0], np.float32)
    want = jax.jit(jeng.unet.apply)({"params": params["unet"]}, jnp.asarray(x),
                                    jnp.asarray(ts), jnp.asarray(ctx))
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx))
    assert got.dtype == torch.float32
    # fp32 through ~20 convs/matmuls and 12 norms: summation-order noise
    # of O(1) activations stays under 1e-4.
    assert_close(got, want, 1e-4)


def test_vae_decode_matches_jax(engines):
    jeng, params, teng = engines
    z = randn((2, 8, 8, 4), 3, scale=0.2)  # scaled latents: z / 0.18215 is O(1)
    want = jax.jit(lambda p, z: jeng.vae.apply({"params": p}, z, method=jeng.vae.decode))(
        params["vae"], jnp.asarray(z))
    with torch.inference_mode():
        got = teng.vae.decode(t(z))
    assert got.shape == (2, 16, 16, 3)
    assert_close(got, want, 1e-4)  # fp32, as for the UNet


def test_tokenizers_match_jax(tmp_path):
    import json

    from sonicdiffusionbayeslab_tpu.models import tokenizer as JT

    prompts = ["a photograph of an astronaut riding a horse", "", "Ünïcode & punctuation!!"]
    np.testing.assert_array_equal(HashTokenizer(1000)(prompts), JT.HashTokenizer(1000)(prompts))
    symbols = list(JT._bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols)}
    vocab.update({s + "</w>": len(vocab) + i for i, s in enumerate(symbols)})
    vocab["ab</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\na b</w>\n")
    texts = ["ab a", "a b ab  AB"]
    np.testing.assert_array_equal(load_tokenizer(str(tmp_path))(texts),
                                  JT.load_tokenizer(str(tmp_path))(texts))
    assert isinstance(load_tokenizer(None), HashTokenizer)
