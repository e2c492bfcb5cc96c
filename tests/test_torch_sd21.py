"""SD-2.x (``variant="sd21"``) in the port against the JAX package (tiny
configs, fp32, CPU): the linear-projection UNet with heads a level, the
OpenCLIP-shaped text tower's three outputs, v-prediction DPM++ plans, the
engine under CFG, the pipeline's variant resolution, and
``configs/sd21_config.yaml`` through the port's CLI."""

import csv
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_methods import COMMON, _jax_points
from torch_parity import assert_close, randn, t, tiny_family_engines
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.models.pipelines import StableDiffusionModel as JaxPipeline
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "sd21_config.yaml")


@pytest.fixture(scope="module")
def engines():
    return tiny_family_engines("sd21")


def test_state_dicts_equal_jax_invert(engines):
    """The port's maps give the JAX converter's names and arrays, with the
    transformers' projections as [out, in] linears; a tree alone reads as
    SD-1.5's 1x1 convs, so SD-2.x needs its config."""
    jeng, params, teng = engines
    sds = W.state_dicts_from_jax(params, UNetConfig.tiny21())
    want = JW.invert(params["unet"], JW.unet_name_map(jeng.unet_config))
    assert sds["unet"].keys() == want.keys()
    for name, v in want.items():
        np.testing.assert_array_equal(sds["unet"][name].numpy(), v, err_msg=name)
    proj = "down_blocks.0.attentions.0.proj_in.weight"
    assert sds["unet"][proj].shape == (32, 32)
    assert W.state_dicts_from_jax(params)["unet"][proj].shape == (32, 32, 1, 1)
    assert set(sds) == {"unet", "vae", "text"}


def test_sd21_unet_map_names_every_port_parameter():
    """Full SD-2.1 geometry: the JAX UNet's parameter paths, mapped by the
    port's name map, are exactly the port's state-dict names and shapes
    (linear proj_in/proj_out, 64-wide heads a level)."""
    from sonicdiffusionbayeslab_tpu.models.unet import UNet2DCondition as JaxUNet
    from sonicdiffusionbayeslab_tpu.models.unet import UNetConfig as JaxConfig

    shapes = jax.eval_shape(JaxUNet(JaxConfig.sd21()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, 1024)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    cfg = UNetConfig.sd21()
    mapped = {k: v.shape for k, v in W.invert(tree, W.unet_name_map(cfg)).items()}
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    assert mapped == {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    heads = [b.attn1.num_heads for b in unet.modules() if hasattr(b, "attn1")]
    assert sorted(set(heads)) == [5, 10, 20] and all(
        b.attn1.head_dim == 64 for b in unet.modules() if hasattr(b, "attn1"))


def test_unet_matches_jax(engines):
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 21.0], np.float32)
    want = jax.jit(jeng.unet.apply)({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts),
                                   jnp.asarray(ctx))
    with torch.inference_mode():
        got = teng.unet(t(x), t(ts), t(ctx))
    assert_close(got, want, 1e-4, 1e-4)  # fp32 through ~20 convs/matmuls


def test_text_tower_outputs_match_jax(engines):
    """last_hidden_state, penultimate_hidden_state (the last layer's input)
    and pooled_output, exact-erf GELU."""
    jeng, params, teng = engines
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77)).astype(np.int32)
    want = jax.jit(jeng.text.apply)({"params": params["text"]}, jnp.asarray(ids))
    with torch.inference_mode():
        got = teng.text.outputs(torch.as_tensor(ids, dtype=torch.long))
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], 1e-5)
    assert_close(teng.encode_prompts(ids), want["last_hidden_state"], 1e-5)


@pytest.mark.parametrize("steps,kw", [
    (10, {}),
    (20, {}),
    (10, {"use_karras_sigmas": True}),
    (20, {"solver_order": 1, "final_sigmas_type": "sigma_min"}),
])
def test_v_prediction_plan_rows_bit_equal(steps, kw):
    """sd21_config's scheduler (DPM++ order 2, final sigma zero,
    v_prediction) and variants: every plan row bit-equal."""
    kw = {"solver_order": 2, "algorithm_type": "dpmsolver++", "final_sigmas_type": "zero",
          "prediction_type": "v_prediction", **kw}
    got, want = S.DPMSolverScheduler(**kw).build_plan(steps).scan_xs(), \
        JS.DPMSolverScheduler(**kw).build_plan(steps).scan_xs()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def cfg_run(engines):
    """The JAX engine's 10-step v-prediction DPM++ CFG 7.5 run from given
    initial latents."""
    jeng, params, teng = engines
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    lat0 = randn((2, 8, 8, 4), 5)
    plan = JS.DPMSolverScheduler(prediction_type="v_prediction").build_plan(10)
    out = jeng.sample(params, plan, jeng.encode_prompts(params, ids),
                      jeng.encode_prompts(params, neg_ids), jax.random.PRNGKey(0),
                      guidance_scale=7.5, latent_hw=(8, 8), init_latents=jnp.asarray(lat0))
    return dict(ids=ids, neg_ids=neg_ids, lat0=lat0, out=out)


@pytest.mark.parametrize("microbatch", [None, 2])
def test_engine_sample_matches_jax(engines, cfg_run, microbatch):
    _, _, teng = engines
    plan = S.DPMSolverScheduler(prediction_type="v_prediction").build_plan(10)
    got = teng.sample(plan, teng.encode_prompts(cfg_run["ids"]),
                      teng.encode_prompts(cfg_run["neg_ids"]), guidance_scale=7.5,
                      latent_hw=(8, 8), init_latents=t(cfg_run["lat0"]), microbatch=microbatch)
    # fp32 through 10 CFG-amplified UNet calls, as the SD-1.5 engine test.
    assert_close(got.latents, cfg_run["out"].latents, 1e-3)
    assert_close(got.images, cfg_run["out"].images, 1e-3)


def test_resolve_variant(tmp_path):
    """Explicit, from the model id's name, and from a local snapshot's
    unet/config.json, as the JAX pipeline resolves it."""
    cases = [("sd15", "stabilityai/stable-diffusion-2-1"), ("sd21", "runwayml/x"),
             ("auto", "stabilityai/stable-diffusion-2-1"), ("auto", "someone/sd2-base"),
             ("auto", "runwayml/stable-diffusion-v1-5")]
    for dim, name in ((1024, "snap21"), (768, "snap15")):
        (tmp_path / name / "unet").mkdir(parents=True)
        (tmp_path / name / "unet" / "config.json").write_text(
            json.dumps({"cross_attention_dim": dim}))
        cases.append(("auto", str(tmp_path / name)))
    got = [StableDiffusionModel._resolve_variant(v, m) for v, m in cases]
    assert got == [JaxPipeline._resolve_variant(v, m) for v, m in cases]
    assert got == ["sd15", "sd21", "sd21", "sd21", "sd15", "sd21", "sd15"]
    with pytest.raises(ValueError, match="unknown variant"):
        StableDiffusionModel._resolve_variant("sd3", "x")


def test_pipeline_builds_the_sd21_engine():
    pipe = StableDiffusionModel(tiny=True, dtype="float32", variant="sd21", device="cpu")
    assert pipe.variant == "sd21" and pipe.engine.unet_config == UNetConfig.tiny21()
    assert pipe.engine.text_config.hidden_act == "gelu"
    imgs, secs, _ = pipe(["a cat"], num_inference_steps=2)
    assert imgs.shape == (1, 16, 16, 3) and np.isfinite(imgs).all() and secs > 0


def test_sd21_config_through_the_cli(tmp_path, monkeypatch, capsys):
    """configs/sd21_config.yaml (variant sd21, v-prediction DPM++) at tiny
    size, 64x64, one sweep point: the JAX method's label and nfe, and the
    scheduler the method built predicts v."""
    overrides = {**COMMON, "experiment_params.num_inference_steps": [3], "logger.run_id": "run"}
    want = _jax_points(CONFIG, overrides)
    built = []
    orig = StableDiffusionModel.__init__

    def recording_init(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(StableDiffusionModel, "__init__", recording_init)
    monkeypatch.chdir(tmp_path)
    metrics = cli.run(CONFIG, overrides, device="cpu")
    assert "run dir: outputs/run" in capsys.readouterr().out
    with open(tmp_path / "outputs" / "run" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert [(r["exp"], int(r["nfe"])) for r in rows] == want == [("steps_3", 3)]
    assert metrics["exp"] == ["steps_3"] and 0.0 <= float(rows[0]["clip_score"]) <= 100.0
    (pipe,) = built
    assert pipe.variant == "sd21" and pipe.scheduler.config.prediction_type == "v_prediction"
    pngs = list((tmp_path / "outputs").glob("*/steps_3/*.png"))
    assert len(pngs) == 2


def test_generate_cli_takes_the_variant(tmp_path, capsys):
    from sonicdiffusionbayeslab_torch import generate

    out = tmp_path / "img_{i:03d}.png"
    generate.main(["--prompt", "a lighthouse", "--tiny", "--device", "cpu", "--steps", "2",
                   "--variant", "sd21", "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    data = (tmp_path / "img_000.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and struct.unpack(">II", data[16:24]) == (16, 16)
