"""The port's quality metrics against the JAX package's (fp32, CPU): the
Fréchet distance, FID-Inception's taps, tiny ImageReward and its
tokenizer, the aesthetic head on the in-repo checkpoint, the ViT-L/14
geometry, the name maps at full size, the published-layout loaders, the
three metric classes' ``compute()`` on the same weights, and each of the
ten shipped SD-1.5 configs through the port's CLI with a real-image
directory and its metrics as shipped."""

import csv
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_init, random_params, t
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import registry as R
from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes
from sonicdiffusionbayeslab_torch.metrics import aesthetic as A
from sonicdiffusionbayeslab_torch.metrics import frechet as Fr
from sonicdiffusionbayeslab_torch.metrics import image_reward_model as IR
from sonicdiffusionbayeslab_torch.metrics import inception as I
from sonicdiffusionbayeslab_torch.metrics import metrics as M
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.clip_vision import CLIPVisionConfig
from sonicdiffusionbayeslab_tpu import registry as JR
from sonicdiffusionbayeslab_tpu.metrics import aesthetic as JA
from sonicdiffusionbayeslab_tpu.metrics import frechet as JFr
from sonicdiffusionbayeslab_tpu.metrics import image_reward_model as JIR
from sonicdiffusionbayeslab_tpu.metrics import inception as JI
from sonicdiffusionbayeslab_tpu.metrics import metrics as JM
from sonicdiffusionbayeslab_tpu.models import clip_vision as JV

REPO = Path(__file__).resolve().parents[1]
ANNOTATIONS = REPO / "data" / "dataset" / "img2annotations_test.json"
AESTHETIC = REPO / "data" / "models" / "aethetic_score_model.pth"
PROMPTS = ["a red bicycle", "a lighthouse on a rocky coast at sunset", "two dogs",
           "a bowl of ramen, top view"]


def images01(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


@pytest.fixture
def fast_flax_init(monkeypatch):
    """Flax's eager ``init`` runs op by op (12 s for the tiny ImageReward
    model); while this fixture is active, JAX modules get random params from
    ``jax.eval_shape`` instead, and each test sets the weights it compares."""
    from flax import linen as nn

    orig = nn.Module.init

    def init(self, rng, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw), rng, *args)
        return {"params": random_params(shapes["params"], 0)}

    monkeypatch.setattr(nn.Module, "init", init)


# --------------------------------------------------------------- Fréchet
def test_frechet_distance_matches_jax():
    """Streamed moments of two feature sets (three updates each) and their
    distance: within 1e-9 relative."""
    rng = np.random.default_rng(0)
    a, b = StreamPair(Fr.StreamingMoments, 16), StreamPair(JFr.StreamingMoments, 16)
    for i in range(3):
        real, fake = rng.normal(0, 1, (7, 16)), rng.normal(0.3, 1.2, (5, 16)) @ rng.normal(
            0, 0.3, (16, 16))
        a.update(real, fake)
        b.update(real, fake)
    for (mu, cov), (jmu, jcov) in zip(a.moments(), b.moments()):
        np.testing.assert_allclose(mu, jmu, rtol=1e-12)
        np.testing.assert_allclose(cov, jcov, rtol=1e-12, atol=1e-14)
    got = Fr.frechet_distance(*a.moments()[0], *a.moments()[1])
    want = JFr.frechet_distance(*b.moments()[0], *b.moments()[1])
    assert got > 0 and abs(got - want) <= 1e-9 * abs(want)
    with pytest.raises(ValueError, match=">= 2 samples"):
        Fr.StreamingMoments(4).mean_cov()


class StreamPair:
    def __init__(self, cls, dim):
        self.real, self.fake = cls(dim), cls(dim)

    def update(self, real, fake):
        self.real.update(real)
        self.fake.update(fake)

    def moments(self):
        return self.real.mean_cov(), self.fake.mean_cov()


# ------------------------------------------------------------- Inception
def _inception_params(max_tap, size, seed=0):
    """Random numpy params of the JAX ``InceptionBlocks`` (variances in
    [0.5, 1.5], so every BatchNorm divides by a positive number)."""
    jm = JI.InceptionBlocks(max_tap=max_tap)
    params = flax_init(jm, seed, np.zeros((1, size, size, 3), np.float32))
    rng = np.random.default_rng(seed + 1)

    def fix(tree):
        return {k: fix(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "bn_var" else v)
                for k, v in tree.items()}

    return jm, fix(params)


def _port_inception(max_tap, params):
    tm = I.InceptionBlocks(max_tap)
    tm.load_state_dict(W.inception_from_jax(params), strict=True)
    return tm.eval()


def test_inception_taps_match_jax():
    """Every tap of the whole network (max_tap 2048) at 75x75, the smallest
    input the geometry takes: within 1e-4 * max(1, |ref|)."""
    jm, params = _inception_params(2048, 75)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port_inception(2048, params)(t(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == list(I.TAPS)
    for tap in I.TAPS:
        w = np.asarray(want[tap])
        assert got[tap].shape == w.shape == (2, tap)
        assert (np.abs(got[tap].numpy() - w) <= 1e-4 * np.maximum(1.0, np.abs(w))).all()


def test_inception_features_through_the_resize_match_jax(fast_flax_init):
    """``InceptionFeatures`` at tap 64: a 64x64 image resized to 299 (the
    antialiased bilinear filter), scaled to [-1, 1], through the stem."""
    _, params = _inception_params(64, 299, seed=3)
    jf = JI.InceptionFeatures(64)
    jf.params = params
    tf = I.InceptionFeatures(64, device="cpu")
    tf.model.load_state_dict(W.inception_from_jax(params), strict=True)
    x = images01((2, 64, 64, 3), 4)
    got, want = tf(x), jf(x)
    assert got.shape == want.shape == (2, 64)
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()


def _pytorch_fid_file(path, params, extra_blocks=True):
    """A pytorch-fid-layout state dict: the tree's units under their torch
    names, with BatchNorm's ``num_batches_tracked``, the ``fc`` head and
    (``extra_blocks``) a block past the tree's deepest tap."""
    sd = dict(W.inception_from_jax(params))
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    if extra_blocks:
        sd["Mixed_5b.branch1x1.conv.weight"] = torch.zeros(64, 192, 1, 1)
    torch.save(sd, path)


def test_pytorch_fid_layout_loads_like_jax(tmp_path):
    """The same file through both loaders (tap 192: the blocks past it, the
    head and the counters are skipped) gives the same tensors; a missing
    tensor raises in the port's loader."""
    jm, params = _inception_params(192, 75, seed=5)
    _pytorch_fid_file(tmp_path / "pt_inception.pth", params)
    jtree = JI.load_inception_weights(str(tmp_path / "pt_inception.pth"), params)
    model = I.load_inception_weights(tmp_path / "pt_inception.pth", I.InceptionBlocks(192))
    want = W.inception_from_jax(jtree)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd = torch.load(tmp_path / "pt_inception.pth", weights_only=True)
    del sd["Conv2d_4a_3x3.bn.running_mean"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Conv2d_4a_3x3.bn.running_mean"):
        I.load_inception_weights(tmp_path / "short.pth", I.InceptionBlocks(192))


# ----------------------------------------------------------- ImageReward
def _reward_pair(seed=0):
    """(JAX tiny ImageRewardScorer, the port's on the CPU) with the same
    random weights."""
    js = JIR.ImageRewardScorer(tiny=True)
    js.params = random_params(jax.eval_shape(lambda: js.params), seed)
    ts = IR.ImageRewardScorer(tiny=True, device="cpu")
    ts.model.load_state_dict(W.image_reward_from_jax(js.params), strict=True)
    return js, ts


def test_tiny_image_reward_matches_jax(fast_flax_init):
    """Raw rewards and z-normalised scores of 64x64 images (normalised,
    then resized to 32) with padded prompts of several lengths: 1e-4."""
    js, ts = _reward_pair()
    x = images01((4, 64, 64, 3), 6)
    ids, mask = js.tokenizer(PROMPTS)
    assert mask.sum(1).tolist() != [mask.sum(1)[0]] * 4  # the padding mask matters
    want = js(x, PROMPTS)
    got = ts(x, PROMPTS)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    raw = ts.raw(t(x), torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask))
    np.testing.assert_allclose(raw.numpy(), want * IR.REWARD_STD + IR.REWARD_MEAN, atol=1e-4)


@pytest.mark.parametrize("vocab", [False, True])
def test_bert_tokenizer_matches_jax(tmp_path, vocab):
    """Ids and masks equal: the FNV hash fallback, and WordPiece on a small
    vocab.txt (whole words, ## pieces, [UNK]); truncation at 35."""
    path = None
    if vocab:
        words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
            "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "red", "bi", "##cy", "##cle", "light",
            "##house", "on", "the", ",", "two", "dog", "##s", "at"]
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(words))
    texts = PROMPTS + ["Bicycle, lighthouse; two dogs! " * 8, ""]
    for size in (1000, 30524):
        got = IR._BertTokenizer(path and str(path), size, 35)(texts)
        want = JIR._BertTokenizer(path and str(path), size, 35)(texts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[1][len(PROMPTS)].sum() == 35


def test_image_reward_checkpoint_loads_like_jax(tmp_path, fast_flax_init):
    """A synthesized ImageReward-v1.0-layout ``.pt`` (fp16, under
    ``state_dict``, with BLIP's projections and a position-id buffer the
    model does not read) through both loaders: the same tensors."""
    js, _ = _reward_pair(seed=1)
    sd = {k: v.half() for k, v in W.image_reward_from_jax(js.params).items()}
    sd["blip.vision_proj.weight"] = torch.zeros(256, 32, dtype=torch.float16)
    sd["blip.text_encoder.bert.embeddings.position_ids"] = torch.arange(512)[None]
    torch.save({"state_dict": sd}, tmp_path / "ImageReward.pt")
    jtree = JIR.load_image_reward_weights(str(tmp_path / "ImageReward.pt"), js.params,
                                          JIR.BLIPConfig.tiny())
    model = IR.load_image_reward_weights(tmp_path / "ImageReward.pt",
                                         IR.ImageRewardModel(IR.BLIPConfig.tiny()))
    want = W.image_reward_from_jax(jtree)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- aesthetic
def test_aesthetic_checkpoint_and_scores_match_jax():
    """The in-repo LAION head through both loaders: equal parameters; scores
    of random 768-d embeddings (normalised in float64): within 1e-5."""
    want = W.aesthetic_from_jax(JA.load_torch_checkpoint(str(AESTHETIC)))
    got = A.load_torch_checkpoint(AESTHETIC)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    emb = np.random.default_rng(7).normal(0, 1, (5, 768)).astype(np.float32)
    np.testing.assert_array_equal(A.normalized(emb), JA.normalized(emb))
    s = A.AestheticScorer(str(AESTHETIC), device="cpu")(emb)
    np.testing.assert_allclose(s, JA.AestheticScorer(str(AESTHETIC))(emb), atol=1e-5, rtol=1e-5)


# -------------------------------------------------- geometry, name maps
def test_vit_l14_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(CLIPVisionConfig.vit_l14()) == dataclasses.asdict(
        JV.CLIPVisionConfig.vit_l14())
    assert CLIPVisionConfig.vit_l14().num_positions == 257


def _full_size(name):
    """(JAX shapes of the full-size tree, the port's state dict on the meta
    device, the name map) of one metric tower."""
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.clip_vision import CLIPDualEncoder
    from sonicdiffusionbayeslab_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig

    if name == "image_reward":
        jm, cfg = JIR.ImageRewardModel(JIR.BLIPConfig()), IR.BLIPConfig()
        args = (jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 35), jnp.int32))
        make = lambda: IR.ImageRewardModel(cfg)  # noqa: E731
        nm = W.image_reward_name_map(24, 12)
    elif name == "inception":
        jm, args = JI.InceptionBlocks(2048), (jnp.zeros((1, 299, 299, 3)),)
        make = lambda: I.InceptionBlocks(2048)  # noqa: E731
        nm = None
    elif name == "aesthetic":
        jm, args = JA.AestheticScoreMLP(768), (jnp.zeros((1, 768)),)
        make = lambda: A.AestheticScoreMLP(768)  # noqa: E731
        nm = W.aesthetic_name_map()
    else:  # the aesthetic score's CLIP ViT-L/14 dual encoder
        jm = JV.CLIPDualEncoder(JV.CLIPVisionConfig.vit_l14(), JCLIPTextConfig.sd15(),
                                projection_dim=768)
        args = (jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32))
        make = lambda: CLIPDualEncoder(CLIPVisionConfig.vit_l14(), CLIPTextConfig.sd15(),  # noqa: E731
                                       projection_dim=768)
        nm = W.clip_dual_name_map(24, 12)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    return shapes, want, nm if nm is not None else W.inception_name_map(shapes)


@pytest.mark.parametrize("name", ["image_reward", "inception", "aesthetic", "clip_l14"])
def test_name_map_names_every_full_size_parameter(name):
    """At full size (JAX shapes from ``jax.eval_shape``, the port's module
    on the meta device): the map covers every JAX path and maps them onto
    exactly the port's tensors, each with its shape."""
    shapes, want, nm = _full_size(name)
    flat = {"/".join(str(k.key) for k in path): s.shape
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(flat) <= set(nm)
    got = {nm[p][0]: nm[p][1](np.zeros(s, np.float32)).shape for p, s in flat.items()}
    assert got == want


# --------------------------------------------------------- metric classes
def _clip_pair(seed, geometry="b16"):
    """A fresh (uncached) tiny CLIP backend in each package with the same
    random weights."""
    jb = JM._ClipBackend(None, tiny=True, geometry=geometry)
    jb.params = random_params(jax.eval_shape(lambda: jb.params), seed)
    tb = M._ClipBackend(None, tiny=True, device="cpu", geometry=geometry)
    tb.model.load_state_dict(W.clip_dual_from_jax(jb.params), strict=True)
    return jb, tb


@pytest.mark.parametrize("path", ["inception_64", "clip_tiny"])
def test_fid_metric_matches_jax(path, fast_flax_init):
    """FID over two batches of real and generated 64x64 images (noise at
    random brightness, and smooth random levels): on the Inception tap 64
    (same random weights), or, tiny, on the tiny CLIP tower's features
    through the fixed projection.  The distance within 1e-4 relative."""
    if path == "inception_64":
        _, params = _inception_params(64, 299, seed=8)
        jm, tm = JM.FID(feature=64), M.FID(feature=64, device="cpu")
        jm._inception.params = params
        tm._inception.model.load_state_dict(W.inception_from_jax(params), strict=True)
    else:
        jm, tm = JM.FID(feature=64, tiny=True), M.FID(feature=64, tiny=True, device="cpu")
        jm.backend, tm.backend = _clip_pair(9)
    for i in range(2):
        real = images01((3, 64, 64, 3), 10 + i) * images01((3, 1, 1, 1), 30 + i)
        fake = np.clip(0.2 * images01((3, 64, 64, 3), 20 + i) + images01((3, 1, 1, 3), 40 + i),
                       0, 1)
        for m in (jm, tm):
            m.update(real, real=True)
            m.update(fake, real=False)
    got, want = tm.compute(), jm.compute()
    assert np.isfinite(got) and got > 0 and abs(got - want) <= 1e-4 * abs(want)
    tm.reset()
    assert tm.real.n == tm.fake.n == 0


def test_image_reward_metric_matches_jax(tmp_path, fast_flax_init):
    """The win rate of generated over real images, tiny, with one
    ImageReward-layout checkpoint in both packages; and the CLIP fallback
    without one (same tiny weights): equal win rates."""
    js, _ = _reward_pair(seed=11)
    torch.save(W.image_reward_from_jax(js.params), tmp_path / "ImageReward.pt")
    real, gen = images01((4, 48, 48, 3), 12), images01((4, 48, 48, 3), 13)
    scores = []
    for pkg, kw in (("port", dict(device="cpu")), ("jax", {})):
        m = (M if pkg == "port" else JM).RewardModel(checkpoint=str(tmp_path / "ImageReward.pt"),
                                                     tiny=True, **kw)
        m.update(PROMPTS, real, gen)
        m.update(PROMPTS[:2], real[:2] ** 2, gen[:2])
        scores.append(m.compute())
    assert scores[0] == scores[1] and 0.0 <= scores[0] <= 1.0
    jb, tb = _clip_pair(14)
    jm, tm = JM.RewardModel(tiny=True, scorer=jb.scores), M.RewardModel(tiny=True, device="cpu")
    tm._scorer = tb.scores
    for m in (jm, tm):
        m.update(PROMPTS, real, gen)
    assert tm.compute() == jm.compute()


def test_aesthetic_metric_matches_jax(fast_flax_init):
    """Tiny: the tiny CLIP tower's image embeddings through a 16-wide head,
    the same random weights in both: mean scores within 1e-5."""
    jm, tm = JM.AestheticScoreMetric(tiny=True), M.AestheticScoreMetric(tiny=True, device="cpu")
    jm.backend, tm.backend = _clip_pair(15)
    jm.scorer.params = random_params(jax.eval_shape(lambda: jm.scorer.params), 16)
    tm.scorer.model.load_state_dict(W.aesthetic_from_jax(jm.scorer.params), strict=True)
    for m in (jm, tm):
        m.update(images01((3, 40, 40, 3), 17))
        m.update(images01((2, 40, 40, 3), 18))
    assert abs(tm.compute() - jm.compute()) <= 1e-5 and tm.n == 5


@pytest.mark.parametrize("name", ["image_reward", "fid", "aesthetic_score"])
def test_metric_arg_specs_match_jax(name):
    """The same arguments and defaults as the JAX package's, plus ``device``."""
    R.load_all_plugins()
    JR.load_all_plugins()
    spec = {k: (s.required, None if s.required else repr(s.default))
            for k, s in R.metrics_registry.arg_specs(name).items() if k != "device"}
    want = {k: (s.required, None if s.required else repr(s.default))
            for k, s in JR.metrics_registry.arg_specs(name).items()}
    assert spec == want
    assert "device" in R.metrics_registry.arg_specs(name)


# ------------------------------------------------- the shipped configs
SD15_CONFIGS = ["default_stable_diffusion", "ddim_config", "dpm_solver_config",
                "deep_cache_config", "consistency_model_config", "two_schedulers_config",
                "interliving_schedulers_config", "skip_steps_config", "unipc_config",
                "tome_config"]


def _tinyify(config):
    """As ``tests/test_experiments.py::_tinyify``: tiny random weights, 64px,
    one batch of 2, each swept list cut to its first value (step counts to
    at most 8); the dataset, method, scheduler and metric sections as
    shipped, but for the image directory (``img_dataset``)."""
    from sonicdiffusionbayeslab_torch.config import load_config

    raw = load_config(str(REPO / "configs" / f"{config}.yaml")).to_dict()
    over = {"model.tiny": True, "model.image_size": 64, "model.dtype": "float32",
            "dataset.image_size": 64, "dataset.max_count": 2, "inference.batch_size": 2,
            "inference.batch_count": 1, "logger.wandb_enable": False, "logger.save": False}
    for k, v in raw.get("experiment_params", {}).items():
        if isinstance(v, list):
            v = [v[0]]
            if k.startswith("num_inference_steps") and isinstance(v[0], int):
                v = [min(v[0], 8)]
            over[f"experiment_params.{k}"] = v
    return over


def _jax_columns(config, overrides, gen):
    """The table row keys of the JAX package's ``validate`` for this config:
    its own ``setup_dataset``, ``setup_metrics`` (each metric replaced by a
    stand-in, so no JAX tower is built) and ``validate`` on a stub of the
    method."""
    from sonicdiffusionbayeslab_tpu.config import load_config
    from sonicdiffusionbayeslab_tpu.experiments import base as JB

    class Stand:
        def __init__(self, **kw):
            pass

        update = reset = lambda self, *a, **k: None  # noqa: E731
        compute = lambda self: 0.5  # noqa: E731

    stub = object.__new__(JB.BaseMethod)
    stub.config = load_config(str(REPO / "configs" / f"{config}.yaml"), overrides)
    stub.metric_dict = {}
    saved = JB.metrics_registry
    try:
        JB.metrics_registry = _StandRegistry(Stand)
        JB.BaseMethod.setup_dataset(stub)
        JB.BaseMethod.setup_metrics(stub)
    finally:
        JB.metrics_registry = saved
    stub.logger = types.SimpleNamespace(log_metrics=lambda *a, **k: None)
    stub.log_images_step, stub.save_images = 0, False
    JB.BaseMethod.validate(stub, gen, label="x")
    return list(stub.metric_dict)


class _StandRegistry:
    def __init__(self, cls):
        self.cls = cls

    def validate_kwargs(self, *a, **k):
        return None

    def __getitem__(self, name):
        return self.cls


@pytest.mark.parametrize("config", SD15_CONFIGS)
def test_shipped_config_runs_with_real_images(config, tmp_path, monkeypatch):
    """The shipped config through the port's CLI on the CPU, made tiny, with
    ``dataset.img_dataset`` a directory of PNGs (named as the annotation
    file's first two .jpg keys) and ``quality_metrics`` as shipped: the
    table has the JAX CLI's columns, with ``fid`` and ``image_reward``."""
    files = sorted(json.loads(ANNOTATIONS.read_text()))[:2]
    rng = np.random.default_rng(0)
    for i, f in enumerate(files):
        (tmp_path / "imgs" / f).parent.mkdir(exist_ok=True)
        (tmp_path / "imgs" / f).write_bytes(encode_png_bytes(
            rng.integers(0, 256, (48 + 16 * i, 80 - 16 * i, 3), dtype=np.uint8)))
    overrides = {**_tinyify(config), "dataset.img_dataset": str(tmp_path / "imgs"),
                 "dataset.prompts": str(ANNOTATIONS), "logger.run_id": "run"}
    monkeypatch.chdir(tmp_path)
    metrics = cli.run(str(REPO / "configs" / f"{config}.yaml"), overrides, device="cpu")
    with open(tmp_path / "outputs" / "run" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    gen = {"images": np.zeros((2, 64, 64, 3), np.uint8), "prompts": ["a", "b"], "files": files,
           "x0_grids": [], "nfe": 1}
    want = _jax_columns(config, overrides, gen)
    assert list(rows[0]) == want == list(metrics)
    assert {"clip_score", "fid", "image_reward"} <= set(want)
    assert len(rows) == 1 and 0.0 <= float(rows[0]["image_reward"]) <= 1.0
    assert np.isfinite(float(rows[0]["fid"])) and np.isfinite(float(rows[0]["clip_score"]))
