"""Prompt weighting (``models/prompt_weighting.py``) in the port against the
JAX package (CPU, fp32): the parser's segments, the ids and weights, the
rescaled states, the SD-1.5 pipeline's weighted encode and the SDXL
pipeline's two-tower weighting, SD3's refusal, and ``generate.py
--prompt_weighting``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, tiny_engines, tiny_family_engines
from sonicdiffusionbayeslab_torch.models import prompt_weighting as PW
from sonicdiffusionbayeslab_torch.models.pipelines import (
    StableDiffusion3Model,
    StableDiffusionModel,
    StableDiffusionXLModel,
)
from sonicdiffusionbayeslab_torch.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.models import prompt_weighting as JPW
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer

PROMPTS = [
    "a cat on a mat", "a (cat) and a ((dog)) plus (bird:1.5) minus [fish]",
    r"a \(literal\) x", "a (cat and dog", "(a (b:2.0) c)", "a smiley :3) on a wall",
    "(cat:.5)", "(cat:1.2.3)", "[[dim]] and (bright:1.3) trailing \\", "",
    "((((" + "word " * 100 + "))))",
]


@pytest.mark.parametrize("text", PROMPTS)
def test_parse_segments_and_weighted_ids_equal_jax(text):
    assert PW.parse_segments(text) == JPW.parse_segments(text)
    tok, jtok = HashTokenizer(vocab_size=1000), JaxHashTokenizer(vocab_size=1000)
    assert PW.weighted_ids(tok, text) == JPW.weighted_ids(jtok, text)


def test_batch_weighted_ids_equal_jax():
    tok, jtok = HashTokenizer(vocab_size=1000), JaxHashTokenizer(vocab_size=1000)
    ids, w = PW.batch_weighted_ids(tok, PROMPTS)
    jids, jw = JPW.batch_weighted_ids(jtok, PROMPTS)
    assert ids.dtype == jids.dtype and w.dtype == jw.dtype and ids.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(w, jw)
    # A prompt without the syntax: the plain tokenizer's ids, weight 1.
    np.testing.assert_array_equal(ids[0], tok(["a cat on a mat"])[0])
    assert (w[0] == 1.0).all()


def test_apply_prompt_weights_matches_jax():
    states = randn((3, 77, 16), 0) + 0.3
    w = np.ones((3, 77), np.float32)
    w[0, 3:6] = 1.5
    w[1, 10] = 0.5
    want = np.asarray(JPW.apply_prompt_weights(jnp.asarray(states), w))
    got = PW.apply_prompt_weights(torch.from_numpy(states), w)
    assert_close(got, want, 1e-5, 1e-5)
    assert_close(got.mean(dim=(1, 2)), states.mean(axis=(1, 2)), 1e-5, 1e-5)
    assert_close(got[2], states[2], 1e-6)  # all-one row: the rescale is the identity
    zero = PW.apply_prompt_weights(torch.zeros(1, 4, 2), np.full((1, 4), 2.0, np.float32))
    assert torch.equal(zero, torch.zeros(1, 4, 2))  # a zero mean is left as it is


def _jax_pipe(cls, jeng, params, **kw):
    saved = cls._load_params
    cls._load_params = lambda self, pm, seed: params
    try:
        pipe = cls(tiny=True, dtype="float32", prompt_weighting=True, **kw)
    finally:
        cls._load_params = saved
    pipe.engine = jeng
    return pipe


def test_pipeline_weighted_states_match_jax():
    """The SD-1.5 pipeline's encode with the syntax on: the JAX pipeline's
    states within 1e-5; without the syntax the plain encode, bit for bit."""
    from sonicdiffusionbayeslab_tpu.models.pipelines import StableDiffusionModel as JaxModel

    jeng, params, teng = tiny_engines()
    jpipe = _jax_pipe(JaxModel, jeng, params)
    tpipe = StableDiffusionModel(tiny=True, dtype="float32", device="cpu", prompt_weighting=True)
    tpipe.engine = teng
    prompts = ["a (red:1.4) boat at [dusk]", "a lighthouse"]
    assert_close(tpipe._encode_uncached(prompts), jpipe._encode_uncached(prompts), 1e-5)
    plain = ["a red boat", "a lighthouse"]
    np.testing.assert_array_equal(tpipe._encode_uncached(plain).numpy(),
                                  teng.encode_prompts(tpipe.tokenizer(plain)).numpy())


def test_sdxl_two_tower_weighting_matches_jax():
    """SDXL: each tower's half of the context is weighted with its own
    tokenizer's weights, the pooled embedding is not."""
    from sonicdiffusionbayeslab_tpu.models.pipelines import StableDiffusionXLModel as JaxXL

    jeng, params, teng = tiny_family_engines("sdxl")
    jpipe = _jax_pipe(JaxXL, jeng, params)
    tpipe = StableDiffusionXLModel(tiny=True, dtype="float32", device="cpu",
                                   prompt_weighting=True)
    tpipe.engine = teng
    prompts = ["a ((cat)) on a [mat]", "a (dog:0.7)"]
    want, got = jpipe._encode(prompts), tpipe._encode(prompts)
    assert_close(got, want, 1e-5)
    assert_close(tpipe._pooled_queue[-1], jpipe._pooled_queue[-1], 1e-5)
    ctx, pooled = teng.encode_prompts_xl(PW.batch_weighted_ids(tpipe.tokenizer, prompts)[0],
                                         PW.batch_weighted_ids(tpipe.tokenizer2, prompts)[0])
    assert not torch.allclose(got, ctx)  # weighted
    torch.testing.assert_close(tpipe._pooled_queue[-1], pooled, atol=0, rtol=0)


def test_weighting_steers_the_image_and_sd3_refuses():
    pipe = StableDiffusionModel(tiny=True, image_size=64, dtype="float32", device="cpu",
                                prompt_weighting=True)
    kw = dict(num_inference_steps=2, guidance_scale=5.0, seed=29)
    plain = pipe(["a cat on a mat"], **kw)[0]
    np.testing.assert_array_equal(plain, pipe(["a cat on a mat"], **kw)[0])
    emph = pipe(["a (cat:1.8) on a mat"], **kw)[0]
    assert np.isfinite(emph).all() and np.abs(emph - plain).max() > 1e-6
    off = StableDiffusionModel(tiny=True, image_size=64, dtype="float32", device="cpu")
    assert not off.prompt_weighting
    with pytest.raises(NotImplementedError, match="prompt weighting"):
        StableDiffusion3Model(tiny=True, dtype="float32", device="cpu", prompt_weighting=True)


def test_generate_prompt_weighting_flag(tmp_path, capsys, monkeypatch):
    from sonicdiffusionbayeslab_torch import generate

    seen = {}
    saved = StableDiffusionModel.__init__

    def init(self, *a, **kw):
        seen.update(kw)
        saved(self, *a, **kw)

    monkeypatch.setattr(StableDiffusionModel, "__init__", init)
    generate.main(["--prompt", "a (lighthouse:1.3)", "--tiny", "--device", "cpu", "--steps", "2",
                   "--prompt_weighting", "--out", str(tmp_path / "img_{i:03d}.png")])
    assert seen["prompt_weighting"] is True
    assert (tmp_path / "img_000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
