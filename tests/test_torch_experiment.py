"""The port's experiment CLI end to end against the JAX package's (tiny
models, fp32, CPU): local snapshots loaded by both pipelines, the
``dpm_solver`` sweep of ``configs/smoke.yaml`` with the same weights and
initial latents, its table, images and resume; and the port's CLI on an
installation without JAX, Flax, PyYAML, pandas and PIL."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_init, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.models.weights import clip_dual_name_map, invert, load_sd_checkpoint
from sonicdiffusionbayeslab_tpu import cli as jcli
from sonicdiffusionbayeslab_tpu.data.imageio import read_image
from sonicdiffusionbayeslab_tpu.models import clip_text as JT
from sonicdiffusionbayeslab_tpu.models import clip_vision as JV
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.models.pipelines import StableDiffusionModel as JStableDiffusionModel

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs" / "smoke.yaml")
PROMPTS = str(REPO / "data" / "dataset" / "prompts_sample.json")


def _save(d: Path, name: str, sd: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, d / name)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A diffusers-layout tiny SD snapshot of the shared tiny JAX tree (the
    VAE with its encoder, the text encoder with its ``position_ids``
    buffer), written by the JAX package's inverse maps, and a
    transformers-layout tiny CLIP checkpoint."""
    root = tmp_path_factory.mktemp("snapshots")
    jeng, params, _ = tiny_engines()
    sd = root / "sd"
    _save(sd / "unet", "diffusion_pytorch_model.bin",
          JW.invert(params["unet"], JW.unet_name_map(jeng.unet_config)))
    vae = JW.invert(params["vae"], JW.vae_name_map(2, 1))
    assert any(k.startswith("encoder.") for k in vae) and "quant_conv.weight" in vae
    _save(sd / "vae", "diffusion_pytorch_model.bin", vae)
    text = JW.invert(params["text"], JW.clip_text_name_map(2))
    text["text_model.embeddings.position_ids"] = np.arange(77)[None]
    _save(sd / "text_encoder", "pytorch_model.bin", text)
    clip = JV.CLIPDualEncoder(JV.CLIPVisionConfig.tiny(), JT.CLIPTextConfig.tiny(), projection_dim=16)
    cparams = flax_init(clip, 7, np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 77), np.int32))
    _save(root / "clip", "pytorch_model.bin", invert(cparams, clip_dual_name_map(2, 2)))
    return {"sd": sd, "clip": root / "clip", "params": params}


def _latents(idx, shape):
    """The initial latents both packages are patched to draw: sample i's
    from numpy seed 100 + i."""
    return np.stack([randn(tuple(shape), 100 + int(i)) for i in np.asarray(idx)])


@pytest.fixture
def same_latents(monkeypatch):
    monkeypatch.setattr("sonicdiffusionbayeslab_tpu.utils.rng.per_sample_latents",
                        lambda key, idx, shape, dtype=jnp.float32: jnp.asarray(_latents(idx, shape)))
    monkeypatch.setattr("sonicdiffusionbayeslab_torch.models.sampler.per_sample_latents",
                        lambda seed, idx, shape, device="cpu", dtype=torch.float32:
                        t(_latents(idx, shape)).to(device=device, dtype=dtype))


def test_snapshot_loads_into_both_pipelines(snapshots, same_latents):
    """Both pipelines load the snapshot (the port drops the VAE encoder and
    the ``position_ids`` buffer by name) to the same weights, and give the
    same images from the same initial latents: fp32 through 4 CFG steps,
    images in [0, 1] within 1e-3."""
    from sonicdiffusionbayeslab_torch.models.weights import state_dicts_from_jax
    from sonicdiffusionbayeslab_tpu.schedulers import DPMSolverScheduler as JDPM

    port = StableDiffusionModel(pretrained_model=str(snapshots["sd"]), tiny=True, dtype="float32",
                                device="cpu")
    want = state_dicts_from_jax(snapshots["params"])
    for key, m in zip(("unet", "vae", "text"), port.engine.modules()):
        got = m.state_dict()
        assert got.keys() == want[key].keys()
        assert all(torch.equal(got[k], want[key][k]) for k in got), key
    jpipe = JStableDiffusionModel(pretrained_model=str(snapshots["sd"]), tiny=True, dtype="float32")
    jpipe.scheduler = JDPM(solver_order=2)
    prompts = ["a red bicycle", "a lighthouse"]
    want_img, _, _ = jpipe(prompts, num_inference_steps=4, guidance_scale=7.5,
                           sample_indices=np.arange(2))
    got_img, _, _ = port(prompts, num_inference_steps=4, guidance_scale=7.5,
                         sample_indices=np.arange(2))
    assert port.num_timesteps == jpipe.num_timesteps == 4
    np.testing.assert_allclose(got_img, np.asarray(want_img), atol=1e-3)


def test_snapshot_extra_or_missing_key_raises(snapshots, tmp_path):
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    teng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                 dtype=torch.float32, device="cpu")
    for sub in ("unet", "vae", "text_encoder"):
        (tmp_path / sub).symlink_to(snapshots["sd"] / sub)
    bad = torch.load(snapshots["sd"] / "unet" / "diffusion_pytorch_model.bin", weights_only=True)
    bad["conv_in.extra"] = torch.zeros(1)
    (tmp_path / "unet").unlink()
    _save(tmp_path / "unet", "diffusion_pytorch_model.bin", bad)
    with pytest.raises(RuntimeError, match="conv_in.extra"):
        load_sd_checkpoint(tmp_path, teng)
    del bad["conv_in.extra"], bad["conv_out.bias"]
    _save(tmp_path / "unet", "diffusion_pytorch_model.bin", bad)
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        load_sd_checkpoint(tmp_path, teng)


def _overrides(snapshots, steps="[4]"):
    return [f"model.pretrained_model={snapshots['sd']}",
            f"quality_metrics.clip_score.model_name_or_path={snapshots['clip']}",
            "model.dtype=float32", f"dataset.prompts={PROMPTS}", "dataset.max_count=2",
            "inference.batch_size=2",
            f"experiment_params.num_inference_steps={steps}", "logger.run_id=cli"]


def _table(path: Path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def test_cli_sweep_matches_jax(snapshots, same_latents, tmp_path, monkeypatch, capsys):
    """``configs/smoke.yaml`` through both CLIs on the same snapshots and
    latents: the same table columns and rows, equal nfe, CLIP scores within
    1e-3 (0-100 scale), saved PNGs within one uint8 level (fp32 on both
    sides; 1e-3 on [0, 1] images before the rounding); then a second port
    run of the same run id resumes from ``sweep_state.json``."""
    for pkg, main in (("jax", jcli), ("port", cli)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        main.run(SMOKE, main._parse_sets(_overrides(snapshots)), **kw)
    assert capsys.readouterr().out.count("run dir: outputs/cli") == 2
    runs = {pkg: tmp_path / pkg / "outputs" / "cli" for pkg in ("jax", "port")}
    for name in ("tables/final.tsv", "metrics.tsv"):
        want, got = _table(runs["jax"] / name), _table(runs["port"] / name)
        assert [r.keys() for r in got] == [r.keys() for r in want]
        assert [(r["exp"], r["nfe"]) for r in got] == [(r["exp"], r["nfe"]) for r in want]
        assert got[0]["nfe"] == "4" and float(got[0]["time"]) > 0
        assert abs(float(got[0]["clip_score"]) - float(want[0]["clip_score"])) <= 1e-3
    pngs = sorted(p.name for p in (tmp_path / "jax" / "outputs" / "smoke" / "steps_4").glob("*.png"))
    assert pngs == ["sample_0001.png", "sample_0002.png"]
    for name in pngs:
        a, b = (read_image(tmp_path / pkg / "outputs" / "smoke" / "steps_4" / name)
                for pkg in ("jax", "port"))
        assert a.shape == b.shape == (16, 16, 3)
        assert np.abs(a - b).max() * 255 <= 1.0 + 1e-6
    for name in ("events.jsonl", "sweep_state.json", "images/samples/steps_4_0.png",
                 "images/x0/steps_4_0_0.png"):
        assert (runs["port"] / name).exists(), name
    metrics = cli.run(SMOKE, cli._parse_sets(_overrides(snapshots, "[4, 6]")), device="cpu")
    assert metrics["exp"] == ["steps_6"] and metrics["nfe"] == [6]  # steps_4 was done


def test_cli_runs_without_jax_pyyaml_pandas_pil(tmp_path):
    """The installation on the card's machine: in a process where ``jax``,
    ``flax``, ``yaml``, ``pandas``, ``PIL`` and the JAX package cannot be
    imported, the port's CLI runs the tiny smoke config on the CPU and
    writes its tables."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'yaml', 'pandas', 'PIL', 'sonicdiffusionbayeslab_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from sonicdiffusionbayeslab_torch import cli\n"
        f"cli.main(['--config', {SMOKE!r}, '--device', 'cpu', '--set', 'dataset.prompts={PROMPTS}',\n"
        "          '--set', 'dataset.max_count=2', '--set', 'experiment_params.num_inference_steps=[2]',\n"
        "          '--set', 'logger.run_id=blocked'])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    run = tmp_path / "outputs" / "blocked"
    rows = _table(run / "tables" / "final.tsv")
    assert [(r["exp"], r["nfe"]) for r in rows] == [("steps_2", "2")]
    assert _table(run / "metrics.tsv") == rows
    assert 0.0 <= float(rows[0]["clip_score"]) <= 100.0


def test_cli_without_device_raises_without_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", SMOKE, "--set", f"dataset.prompts={PROMPTS}"])


# SD3 with T5 on a snapshot whose tokenizer_3 holds a tokenizer.json the
# reader cannot read ("{}": no model): through the flow scheduler and the
# flow_euler method, each on an SD3 pipeline, it raises naming what it
# does not read, never falling back to hash ids.
_SD3_T5 = {"model.pretrained_model": "sd3", "model.use_t5": True}


@pytest.mark.parametrize("overrides,match", [
    ({"inference.quant": "int4"}, "inference.quant"),
    ({"scheduler.scheduler_name": "flow_match_euler_scheduler",
      "model.model_name": "stable_diffusion_3_model", **_SD3_T5}, "model None is not read"),
    # Ported: the experiment passes no control image, which it refuses as JAX's does.
    ({"model.model_name": "stable_diffusion_controlnet_model"}, "requires control_image"),
    ({"experiment.method": "flow_euler",
      "model.model_name": "stable_diffusion_3_model_skip_timesteps", **_SD3_T5},
     "model None is not read"),
])
def test_cli_names_what_is_not_ported(tmp_path, monkeypatch, overrides, match):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "sd3" / "tokenizer_3").mkdir(parents=True)
    (tmp_path / "sd3" / "tokenizer_3" / "tokenizer.json").write_text("{}")
    with pytest.raises((NotImplementedError, KeyError, ValueError), match=match):
        cli.run(SMOKE, {"dataset.prompts": PROMPTS, **overrides}, device="cpu")


def test_cli_image_dataset_with_missing_images_raises(tmp_path, monkeypatch):
    """``dataset.img_dataset`` names a directory without the prompt file's
    images: the dataset says how many are missing, as the JAX package's."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="dataset images missing"):
        cli.run(SMOKE, {"dataset.prompts": PROMPTS, "dataset.img_dataset": str(tmp_path)},
                device="cpu")
