"""The port's ``SDBL_*`` defaults (``utils/env.py``) and its parity shims,
against the JAX package where it has the same surface.

Each variable is read with the JAX package's precedence (an explicit
argument beats the variable, the variable beats the default) and error
words, and only by ``utils/env.py``.  The shims:
``StableDiffusionModel.from_pretrained`` and ``.to``, the schedulers'
``from_config``, ``utils/images.py``'s ``to_pil_image``, ``save_image`` and
``collate_x0_grid``, ``ops/tome.py::merge_wavg``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import quality_frontier as QF
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.metrics import image_reward_model as IRM
from sonicdiffusionbayeslab_torch.metrics.metrics import RewardModel
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.ops import quant as Q
from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig, bipartite_soft_matching_2d, merge_wavg
from sonicdiffusionbayeslab_torch.parallel import distributed as D
from sonicdiffusionbayeslab_torch.utils import images as I
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.ops import quant as JQ
from sonicdiffusionbayeslab_tpu.utils import images as JI

REPO = Path(__file__).resolve().parents[1]
TINY = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny())


def _engine(**kw):
    return StableDiffusionEngine(*TINY, dtype=torch.float32, device="cpu", **kw)


def _sample(eng, **kw):
    rng = np.random.default_rng(41)
    emb, neg = (t(rng.standard_normal((2, 77, 32)).astype(np.float32)) for _ in range(2))
    return eng.sample(S.DPMSolverScheduler(solver_order=2).build_plan(2), emb, neg,
                      guidance_scale=7.5, latent_hw=(8, 8), init_latents=t(randn((2, 8, 8, 4), 42)),
                      **kw)


def test_only_utils_env_reads_the_variables():
    """No module of the port but ``utils/env.py`` names an ``SDBL_``
    variable in an environment read."""
    read = re.compile(r"(environ|getenv)[^\n]*SDBL_")
    hits = [str(p.relative_to(REPO)) for p in (REPO / "sonicdiffusionbayeslab_torch").rglob("*.py")
            if read.search(p.read_text()) and p.name != "env.py"]
    assert hits == []


@pytest.mark.parametrize("value", ["int8", "INT8_CONV ", "int8_conv_only", "", "int4"])
def test_sdbl_quant(monkeypatch, value):
    """``SDBL_QUANT`` is the mode ``get_quant_mode`` returns and an engine's
    UNet starts in, ``dense_quant_enabled``/``conv_quant_enabled`` as the
    JAX package's; an unknown value raises with its words; the engine's
    ``set_quant_mode(None)`` beats the variable."""
    monkeypatch.setenv("SDBL_QUANT", value)
    monkeypatch.setattr(JQ, "_MODE", None)
    if value == "int4":
        with pytest.raises(ValueError) as jerr:
            JQ.get_quant_mode()
        with pytest.raises(ValueError) as err:
            Q.get_quant_mode()
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError, match="unknown SDBL_QUANT"):
            _engine()
        return
    assert Q.get_quant_mode() == JQ.get_quant_mode()
    assert Q.dense_quant_enabled() == JQ.dense_quant_enabled()
    assert Q.conv_quant_enabled() == JQ.conv_quant_enabled()
    eng = _engine()
    assert eng.unet.quant_mode == JQ.get_quant_mode()
    assert eng.vae.decoder.mid_block.attentions[0].quant_mode is None  # the VAE stays exact
    eng.set_quant_mode(None)
    assert eng.unet.quant_mode is None


def test_sdbl_tome_ratio_and_unet_microbatch(monkeypatch):
    """``SDBL_TOME_RATIO`` and ``SDBL_UNET_MICROBATCH`` are a ``sample``
    call's defaults (bit-equal to passing them); an explicit argument beats
    them; a value that is no number raises Python's own ValueError, as in
    the JAX package; a microbatch that does not divide raises its words."""
    eng = tiny_engines()[2]
    tome = _sample(eng, tome=0.4)
    chunked = _sample(eng, microbatch=2)
    plain = _sample(eng)
    monkeypatch.setenv("SDBL_TOME_RATIO", "0.4")
    monkeypatch.setenv("SDBL_UNET_MICROBATCH", "2")
    both = _sample(eng, microbatch=0)
    assert torch.equal(both.images, tome.images)
    assert torch.equal(_sample(eng, tome=0.0).images, chunked.images)
    assert torch.equal(_sample(eng, tome=TomeConfig(0.4), microbatch=1).images, tome.images)
    assert not torch.equal(plain.images, tome.images)
    monkeypatch.setenv("SDBL_UNET_MICROBATCH", "3")
    with pytest.raises(ValueError, match="unet_microbatch 3 must divide the model batch 4"):
        _sample(eng, tome=0.0)
    monkeypatch.setenv("SDBL_TOME_RATIO", "half")
    with pytest.raises(ValueError, match="could not convert string to float: 'half'"):
        _sample(eng, microbatch=0)


def test_sdbl_cfg_prefix_and_check_nans_defer_to_arguments(monkeypatch):
    """Any non-empty ``SDBL_CFG_PREFIX`` or ``SDBL_CHECK_NANS`` turns each
    on (the JAX package tests the string), and ``cfg_prefix=False`` /
    ``check_nans=False`` beat them."""
    from sonicdiffusionbayeslab_torch.utils import env

    for name, read in (("SDBL_CFG_PREFIX", env.cfg_prefix), ("SDBL_CHECK_NANS", env.check_nans)):
        monkeypatch.delenv(name, raising=False)
        assert read() is False and read(True) is True
        monkeypatch.setenv(name, "0")
        assert read() is True and read(False) is False
    eng = tiny_engines()[2]
    calls = []
    inner = eng.denoise
    eng.denoise = lambda *a, **static: calls.append(static) or inner(*a, **static)
    try:
        _sample(eng, cfg_prefix=False)
        _sample(eng)
    finally:
        del eng.denoise
    assert [c.get("cfg_shared_prefix", False) for c in calls] == [False, False, True, True]


def test_sdbl_coordinator(monkeypatch):
    """``initialize`` takes ``SDBL_COORDINATOR`` where no coordinator is
    given (and then needs the process count and id, as it does for an
    argument); without either it does nothing."""
    monkeypatch.delenv("SDBL_COORDINATOR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert D.initialize() is False
    monkeypatch.setenv("SDBL_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match=r"together, got \('localhost:1', None, None\)"):
        D.initialize()


def test_sdbl_image_reward_ckpt(monkeypatch, tmp_path):
    """The ImageReward metric loads ``checkpoint=``, else the variable's
    path, as the JAX package's metric does."""
    seen = []

    class Scorer:
        def __init__(self, checkpoint, **kw):
            seen.append(checkpoint)

    monkeypatch.setattr(IRM, "ImageRewardScorer", Scorer)
    monkeypatch.setenv("SDBL_IMAGE_REWARD_CKPT", str(tmp_path / "ir.pt"))
    RewardModel(device="cpu")
    RewardModel(checkpoint="given.pt", device="cpu")
    assert seen == [str(tmp_path / "ir.pt"), "given.pt"]


def test_sdbl_snapshots_are_the_frontier_defaults(monkeypatch):
    """``--sd15``, ``--clip`` and ``--sd3`` default to ``SDBL_SD15_SNAPSHOT``,
    ``SDBL_CLIP_SNAPSHOT`` and ``SDBL_SD3_SNAPSHOT``; without ``--sd15`` or
    its variable the tool stops with the JAX tool's hint."""
    from sonicdiffusionbayeslab_torch.metrics import metrics as M

    for name in ("SDBL_SD15_SNAPSHOT", "SDBL_CLIP_SNAPSHOT", "SDBL_SD3_SNAPSHOT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit):
        QF.main([])
    seen = {}

    class Stop(Exception):
        pass

    def build_pipe(family, snapshot, *a, **kw):
        seen[family] = snapshot
        raise Stop

    monkeypatch.setattr(QF, "build_pipe", build_pipe)
    monkeypatch.setattr(M, "ClipScoreMetric", lambda model_name_or_path, **kw:
                        seen.setdefault("clip", model_name_or_path))
    monkeypatch.setenv("SDBL_SD15_SNAPSHOT", "/snap/sd15")
    monkeypatch.setenv("SDBL_CLIP_SNAPSHOT", "/snap/clip")
    with pytest.raises(Stop):
        QF.main(["--prompts", "1"])
    assert seen == {"clip": "/snap/clip", "sd15": "/snap/sd15"}
    with pytest.raises(Stop):
        QF.main(["--prompts", "1", "--sd15", "/given"])
    assert seen["sd15"] == "/given"


def test_pipeline_from_pretrained_and_to():
    """``from_pretrained`` builds the pipeline as the JAX shim does;
    ``to`` returns the pipeline for its own device and raises, naming both,
    for any other, so the port never moves without being asked."""
    pipe = StableDiffusionModel.from_pretrained("not/a/snapshot", tiny=True, dtype="float32",
                                                device="cpu")
    assert isinstance(pipe, StableDiffusionModel) and pipe.pretrained_model == "not/a/snapshot"
    assert pipe.to("cpu") is pipe and pipe.to(torch.device("cpu")) is pipe
    with pytest.raises(ValueError, match="runs on cpu; it does not move to cuda"):
        pipe.to("cuda")


@pytest.mark.parametrize("name", ["DDIMScheduler", "DPMSolverScheduler", "EulerScheduler"])
def test_scheduler_from_config_matches_jax(name):
    config = {"beta_schedule": "scaled_linear", "timestep_spacing": "trailing"}
    got = getattr(S, name).from_config(config, prediction_type="v_prediction").build_plan(6)
    want = getattr(JS, name).from_config(config, prediction_type="v_prediction").build_plan(6)
    g, w = got.scan_xs(), want.scan_xs()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].tobytes() == w[k].tobytes(), k


IMAGES = {
    "float_hwc": np.random.default_rng(43).random((9, 7, 3)).astype(np.float32),
    "uint8_hwc": np.random.default_rng(44).integers(0, 256, (6, 5, 3), dtype=np.uint8),
    "float_chw": np.random.default_rng(45).random((3, 8, 6)).astype(np.float32),
    "one_channel": np.random.default_rng(46).random((5, 4, 1)).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_to_pil_image_and_save_image_match_jax(name, tmp_path):
    """The same pixels and mode as the JAX package's PIL image, and the
    same pixels read back from both packages' files (the port writes RGB
    through its own PNG encoder)."""
    from PIL import Image

    img = IMAGES[name]
    got, want = I.to_pil_image(img), JI.to_pil_image(img)
    assert got.mode == want.mode
    assert np.array_equal(np.asarray(got), np.asarray(want))
    I.save_image(img, tmp_path / "port" / "a.png")
    JI.save_image(img, tmp_path / "jax" / "a.png")
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / "a.png")),
                          np.asarray(Image.open(tmp_path / "jax" / "a.png")))


def test_collate_x0_grid_and_merge_wavg_match_jax():
    import jax.numpy as jnp

    from sonicdiffusionbayeslab_tpu.ops import tome as JT

    frames = [np.random.default_rng(47 + i).random((4, 4, 3)).astype(np.float32) for i in range(5)]
    assert np.array_equal(I.collate_x0_grid(frames, nrow=2), JI.collate_x0_grid(frames, nrow=2))
    x = randn((2, 16, 8), 48)
    cfg = TomeConfig(0.5, rand=False)
    merge, _ = bipartite_soft_matching_2d(t(x), 4, 4, cfg)
    assert torch.equal(merge_wavg(merge, t(x)), merge(t(x)))
    jmerge, _ = JT.bipartite_soft_matching_2d(jnp.asarray(x), 4, 4, JT.TomeConfig(0.5, rand=False))
    np.testing.assert_allclose(merge_wavg(merge, t(x)).numpy(),
                               np.asarray(JT.merge_wavg(jmerge, jnp.asarray(x))), atol=1e-6)
