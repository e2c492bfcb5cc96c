"""The port's CLIP score stack against the JAX package (fp32, CPU): the
resize, the vision and text towers, the dual encoder's embeddings and
scores on the same weights, the name map at full ViT-B/16 size, and a
transformers-layout checkpoint loaded by both packages' metrics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, flax_init, randn, t
from sonicdiffusionbayeslab_torch.metrics.metrics import ClipScoreMetric
from sonicdiffusionbayeslab_torch.models import clip_vision as V
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.weights import clip_dual_name_map, invert
from sonicdiffusionbayeslab_tpu.metrics.metrics import ClipScoreMetric as JClipScoreMetric
from sonicdiffusionbayeslab_tpu.models import clip_text as JT
from sonicdiffusionbayeslab_tpu.models import clip_vision as JV
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

PROMPTS = ["a red bicycle", "a lighthouse on a rocky coast at sunset"]


def images01(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


# (vision, text, projection) of each tested geometry, in both packages' config
# classes: the tiny tower, and two layers of ViT-B/16's widths (12 heads of
# 64, 224x224 input) under two layers of its text tower's (512 wide, 8 heads;
# a 1000-token vocabulary, which the hash tokenizer fills).
GEOMETRIES = {
    "tiny": (dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                  intermediate_size=64),
             dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                  intermediate_size=64), 16, 64),
    "b16_heads": (dict(image_size=224, patch_size=16, hidden_size=768, num_layers=2,
                       num_heads=12, intermediate_size=3072),
                  dict(vocab_size=1000, hidden_size=512, num_layers=2, num_heads=8,
                       intermediate_size=2048), 512, 512),
}


def dual_pair(name, seed=0):
    """(JAX dual encoder, its random numpy params, the port's on the CPU with
    the same weights through ``clip_dual_name_map``, input image size)."""
    vkw, tkw, proj, size = GEOMETRIES[name]
    jm = JV.CLIPDualEncoder(JV.CLIPVisionConfig(**vkw), JT.CLIPTextConfig(**tkw), projection_dim=proj)
    params = flax_init(jm, seed, np.zeros((1, vkw["image_size"], vkw["image_size"], 3), np.float32),
                       np.zeros((1, 77), np.int32))
    tm = V.CLIPDualEncoder(V.CLIPVisionConfig(**vkw), CLIPTextConfig(**tkw), projection_dim=proj)
    sd = invert(params, clip_dual_name_map(vkw["num_layers"], tkw["num_layers"]))
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    return jm, params, tm.eval(), size


@pytest.mark.parametrize("src,dst", [(64, 32), (512, 224)])
def test_clip_resize_matches_jax(src, dst):
    """The normalise-then-resize of ``embed_image``: an antialiased bilinear
    filter in both.  fp32 sums of a few taps: within 1e-6 (2.4e-7 at
    512->224 seen)."""
    x = images01((2, src, src, 3), 0)
    mean, std = np.asarray(V._MEAN, np.float32), np.asarray(V._STD, np.float32)
    want = jax.image.resize((jnp.asarray(x) - mean) / std, (2, dst, dst, 3), method="bilinear")
    got = V.clip_pixels(t(x), dst).permute(0, 2, 3, 1)
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_clip_dual_encoder_matches_jax(geometry):
    """Image embeddings (after the resize), text embeddings and CLIP scores
    on the same weights.  Embeddings are unit vectors in fp32, summed in
    another order: 1e-5; scores on the 0-100 scale: 1e-3."""
    jm, params, tm, size = dual_pair(geometry)
    x = images01((2, size, size, 3), 1)
    ids = HashTokenizer(vocab_size=1000)(PROMPTS)
    with torch.no_grad():
        img, txt = tm.embed_image(t(x)), tm.embed_text(torch.as_tensor(ids, dtype=torch.long))
        score = tm(t(x), torch.as_tensor(ids, dtype=torch.long))
    p = {"params": params}
    assert_close(img, jm.apply(p, jnp.asarray(x), method=jm.embed_image), 1e-5)
    assert_close(txt, jm.apply(p, jnp.asarray(ids), method=jm.embed_text), 1e-5)
    assert_close(score, jm.apply(p, jnp.asarray(x), jnp.asarray(ids)), 1e-3)


def test_clip_vision_model_matches_jax():
    """``CLIPVisionModel`` alone (pooled class token, before the projection)
    on the tiny tower's weights: fp32, 1e-5."""
    vkw = GEOMETRIES["tiny"][0]
    jm = JV.CLIPVisionModel(JV.CLIPVisionConfig(**vkw))
    x = randn((2, 32, 32, 3), 2)
    params = flax_init(jm, 3, x)
    sd = invert({"vision": params}, clip_dual_name_map(vkw["num_layers"], 0))
    tm = V.CLIPVisionModel(V.CLIPVisionConfig(**vkw))
    tm.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm.eval()(t(x).permute(0, 3, 1, 2))
    assert_close(got, jm.apply({"params": params}, jnp.asarray(x))[0], 1e-5)


def test_clip_dual_name_map_names_every_b16_parameter():
    """At full ViT-B/16 size (JAX shapes from ``jax.eval_shape``, the port's
    module on the meta device): the map covers every JAX path, maps them
    onto exactly the port's parameters, and the layout change gives each
    its shape."""
    jm = JV.CLIPDualEncoder(JV.CLIPVisionConfig(), JV.CLIP_B16_TEXT, projection_dim=512)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 77), jnp.int32))["params"]
    flat = {"/".join(str(k.key) for k in path): s.shape
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        tm = V.CLIPDualEncoder(V.CLIPVisionConfig(), V.CLIP_B16_TEXT, projection_dim=512)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    nm = clip_dual_name_map(12, 12)
    assert set(flat) <= set(nm)
    got = {nm[p][0]: nm[p][1](np.zeros(s, np.float32)).shape for p, s in flat.items()}
    assert got == want
    assert want["vision_model.embeddings.position_embedding.weight"] == (197, 768)


def _clip_snapshot(tmp_path, params, **extra):
    sd = {k: t(v) for k, v in invert(params, clip_dual_name_map(2, 2)).items()}
    sd.update({"logit_scale": torch.tensor(4.6052),
               "text_model.embeddings.position_ids": torch.arange(77)[None],
               "vision_model.embeddings.position_ids": torch.arange(17)[None]}, **extra)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    return str(tmp_path)


def test_clip_score_metric_loads_checkpoint_like_jax(tmp_path):
    """A transformers-layout ``pytorch_model.bin`` (with the position-id
    buffers and logit scale a real one carries) loads in both packages'
    ``clip_score`` metrics and gives the same mean score (1e-3)."""
    _, params, _, _ = dual_pair("tiny", seed=4)
    path = _clip_snapshot(tmp_path, params)
    x = images01((4, 64, 64, 3), 5)
    prompts = PROMPTS + ["a bowl of ramen", "two dogs"]
    want = JClipScoreMetric(model_name_or_path=path, tiny=True).calc_metric(x, prompts)
    got = ClipScoreMetric(model_name_or_path=path, tiny=True, device="cpu").calc_metric(x, prompts)
    assert 0.0 <= got <= 100.0
    assert abs(got - want) <= 1e-3


def test_clip_checkpoint_extra_or_missing_key_raises(tmp_path):
    from sonicdiffusionbayeslab_torch.metrics.metrics import _ClipBackend

    _, params, _, _ = dual_pair("tiny", seed=4)
    (tmp_path / "extra").mkdir()
    path = _clip_snapshot(tmp_path / "extra", params, **{"vision_model.extra": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="vision_model.extra"):
        _ClipBackend(path, tiny=True, device="cpu")
    (tmp_path / "missing").mkdir()
    del params["visual_projection"]
    path = _clip_snapshot(tmp_path / "missing", params)
    with pytest.raises(RuntimeError, match="visual_projection.weight"):
        _ClipBackend(path, tiny=True, device="cpu")


def test_random_clip_tower_warns(caplog):
    from sonicdiffusionbayeslab_torch.metrics.metrics import _ClipBackend

    with caplog.at_level("WARNING"):
        b = _ClipBackend("no/such/snapshot", tiny=True, device="cpu")
    assert "RANDOM-init" in caplog.text
    s = b.scores(images01((2, 64, 64, 3), 6), PROMPTS)
    assert s.shape == (2,) and np.isfinite(s).all()
