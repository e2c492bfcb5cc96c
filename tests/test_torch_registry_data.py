"""The port's registries, prompt dataset, image/table helpers and local
logger against the JAX package's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from sonicdiffusionbayeslab_torch import registry as R
from sonicdiffusionbayeslab_torch.data.dataset import PromptDataset, batched
from sonicdiffusionbayeslab_torch.loggers import Logger
from sonicdiffusionbayeslab_torch.utils import images as I
from sonicdiffusionbayeslab_torch.utils.class_registry import RegistryError
from sonicdiffusionbayeslab_tpu import registry as JR
from sonicdiffusionbayeslab_tpu.data.dataset import PromptDataset as JPromptDataset
from sonicdiffusionbayeslab_tpu.data.dataset import batched as jbatched
from sonicdiffusionbayeslab_tpu.loggers import Logger as JLogger
from sonicdiffusionbayeslab_tpu.utils import images as JI
from sonicdiffusionbayeslab_tpu.utils.class_registry import RegistryError as JRegistryError

REPO = Path(__file__).resolve().parents[1]
REGISTRIES = ("models_registry", "methods_registry", "metrics_registry", "schedulers_registry")
# The port's own addition to a ported signature: where the model and the
# metric run.
PORT_ONLY_KWARGS = {"stable_diffusion_model": {"device"}, "clip_score": {"device"}}

R.load_all_plugins()
JR.load_all_plugins()


def _spec(s):
    return (s.name, s.required, None if s.required else repr(s.default),
            s.annotation if isinstance(s.annotation, str) else None)


@pytest.mark.parametrize("reg", REGISTRIES)
def test_registry_names_are_jax_names(reg):
    """Every name the port registers is the JAX package's; every other JAX
    name raises RegistryError saying it is not ported yet."""
    port, jax_reg = getattr(R, reg), getattr(JR, reg)
    assert set(port.keys()) <= set(jax_reg.keys())
    assert set(port.keys()) | port.not_ported == set(jax_reg.keys())
    for name in sorted(set(jax_reg.keys()) - set(port.keys())):
        with pytest.raises(RegistryError, match="not ported yet"):
            port[name]
        with pytest.raises(RegistryError, match="not ported yet"):
            port.validate_kwargs(name, {})


@pytest.mark.parametrize("reg,name", [
    ("models_registry", "stable_diffusion_model"), ("methods_registry", "dpm_solver"),
    ("metrics_registry", "time_metric"), ("metrics_registry", "clip_score"),
    ("schedulers_registry", "dpm_solver_scheduler"),
])
def test_ported_arg_specs_match_jax(reg, name):
    """The port's arg specs are the JAX package's (the pipeline keeps the
    JAX arguments it has features for, with the same defaults)."""
    port = {k: _spec(s) for k, s in getattr(R, reg).arg_specs(name).items()}
    want = {k: _spec(s) for k, s in getattr(JR, reg).arg_specs(name).items()}
    extra = PORT_ONLY_KWARGS.get(name, set())
    assert set(port) - extra <= set(want)
    assert {k: v for k, v in port.items() if k not in extra} == {k: want[k] for k in port
                                                                  if k not in extra}
    if reg != "models_registry":
        assert set(port) - extra == set(want)


@pytest.mark.parametrize("name,kwargs,exc", [
    ("nope_scheduler", {}, "unknown name"),
    ("dpm_solver_scheduler", {"sovler_order": 2}, "unknown config keys"),
])
def test_validate_kwargs_errors_match_jax(name, kwargs, exc):
    with pytest.raises((RegistryError, TypeError)) as got:
        R.schedulers_registry.validate_kwargs(name, kwargs)
    with pytest.raises((JRegistryError, TypeError)) as want:
        JR.schedulers_registry.validate_kwargs(name, kwargs)
    assert type(got.value).__name__ == type(want.value).__name__
    assert exc in str(got.value)
    if name == "dpm_solver_scheduler":
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("prompts", ["prompts_sample.json", "img2annotations_test.json"])
@pytest.mark.parametrize("max_count,batch_size", [(None, 8), (None, 7), (5, 2), (1, 4), (40, 16)])
def test_prompt_batches_match_jax(prompts, max_count, batch_size):
    path = REPO / "data" / "dataset" / prompts
    got = list(batched(PromptDataset(path, max_count=max_count), batch_size))
    want = list(jbatched(JPromptDataset(path, max_count=max_count), batch_size))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["prompt"] == w["prompt"] and g["image_file"] == w["image_file"]
        np.testing.assert_array_equal(g["index"], w["index"])


@pytest.mark.parametrize("max_count", [0, -1])
def test_prompt_dataset_rejects_nonpositive_max_count(max_count):
    with pytest.raises(ValueError, match="max_count"):
        PromptDataset(REPO / "data" / "dataset" / "prompts_sample.json", max_count=max_count)


def test_grid_and_uint8_match_jax():
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(I.to_uint8(x), JI.to_uint8(x))
    for nrow in (2, 8):
        np.testing.assert_array_equal(I.make_grid(I.to_uint8(x), nrow=nrow),
                                      JI.make_grid(JI.to_uint8(x), nrow=nrow))


def test_save_table_matches_pandas(tmp_path):
    """The TSV is byte-equal to the JAX package's (pandas ``to_csv``)."""
    rows = {"exp": ["steps_4", "a\tb", 'q"x'], "nfe": [4, 8, 16],
            "time": [0.1, 1e-05, 123456.789012345678], "clip_score": [float("nan"), 0.5, 2.0],
            "flag": [True, False, True], "mixed": [1, 2.5, np.float32(0.3)]}
    got = I.save_table(rows, tmp_path / "port", "metrics")
    want = JI.save_table(rows, tmp_path / "jax", "metrics")
    assert got.read_bytes() == want.read_bytes()


def test_local_logger_writes_what_jax_does(tmp_path, monkeypatch):
    """Events, tables and image grids land under ``outputs/<run_id>`` of the
    working directory with the same names and contents (event times aside)."""
    monkeypatch.chdir(tmp_path)
    imgs = np.random.default_rng(1).uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    for cls in (Logger, JLogger):
        log = cls(wandb_enable=False, run_name="r", run_id=f"run-{cls.__module__.split('.')[0]}")
        log.log_metrics({"metrics/time": np.float64(0.5), "metrics/nfe": 4}, step=0)
        log.log_metrics_into_table({"exp": ["steps_4"], "nfe": [4]}, name="final")
        log.log_batch_of_images(imgs, name="samples/steps_4", captions=["a", "b", "c"], step=0)
        log.finish()
    port, jax_dir = (tmp_path / "outputs" / f"run-{p}" for p in
                     ("sonicdiffusionbayeslab_torch", "sonicdiffusionbayeslab_tpu"))
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    for f in files:
        if f.name == "events.jsonl":
            strip = lambda p: [{k: v for k, v in json.loads(s).items() if k != "t"}  # noqa: E731
                               for s in p.read_text().splitlines()]
            assert strip(port / f) == strip(jax_dir / f)
        elif f.suffix != ".png":  # the PNG encoders differ; their pixels are checked below
            assert (port / f).read_bytes() == (jax_dir / f).read_bytes(), f
    from sonicdiffusionbayeslab_tpu.data.imageio import read_image

    png = Path("images/samples/steps_4_0.png")
    np.testing.assert_array_equal(read_image(port / png, None), read_image(jax_dir / png, None))


def test_wandb_missing_raises_and_the_facade_logs_it(tmp_path, monkeypatch):
    """wandb is imported only when enabled; where it is missing the wandb
    logger raises ImportError and the facade keeps the local log, with a
    ``wandb_unavailable`` event, as the JAX package's does."""
    from sonicdiffusionbayeslab_torch.loggers import WandbLogger

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        WandbLogger("p", "r")
    log = Logger(wandb_enable=True, run_id="w")
    log.finish()
    assert log.wandb is None and log.run_id == "w"
    assert json.loads((tmp_path / "outputs" / "w" / "events.jsonl").read_text())["event"] == \
        "wandb_unavailable"
    # Disabled, wandb is never imported (it is blocked here).
    log = Logger(wandb_enable=False, run_id="off")
    log.finish()
    assert (tmp_path / "outputs" / "off" / "events.jsonl").read_text() == ""


def test_wandb_logger_drives_the_wandb_api(tmp_path, monkeypatch):
    """With wandb enabled, the facade logs metrics, the table and captioned
    images through wandb's API (a stub module records the calls) beside the
    local log, and resumes an explicit run id."""
    import types

    calls = []
    wandb = types.ModuleType("wandb")
    wandb.login = lambda key=None: calls.append(("login", key))
    wandb.init = lambda **kw: calls.append(("init", kw)) or types.SimpleNamespace(
        id=kw["id"], finish=lambda: calls.append(("finish",)))
    wandb.log = lambda data, step=None: calls.append(("log", data, step))
    wandb.Table = lambda columns, data: ("table", columns, data)
    wandb.Image = lambda arr, caption=None: ("image", np.asarray(arr).shape, caption)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setenv("WANDB_KEY", "k")
    monkeypatch.chdir(tmp_path)
    log = Logger(config={"a": 1}, wandb_enable=True, project_name="p", run_name="r", run_id="id7")
    log.log_metrics({"metrics/time": 0.5}, step=1)
    log.log_metrics_into_table({"exp": ["steps_4", "steps_8"], "nfe": [4, 8]}, name="final")
    log.log_batch_of_images(np.zeros((2, 4, 4, 3)), name="s", captions=["a", "b"], step=1)
    log.finish()
    assert log.run_id == "id7"
    assert calls[:2] == [("login", "k"), ("init", dict(project="p", name="r", id="id7",
                                                       resume="allow", config={"a": 1}))]
    assert ("log", {"metrics/time": 0.5}, 1) in calls
    assert ("log", {"final": ("table", ["exp", "nfe"], [["steps_4", 4], ["steps_8", 8]])},
            None) in calls
    assert ("log", {"s": [("image", (4, 4, 3), "a"), ("image", (4, 4, 3), "b")]}, 1) in calls
    assert calls[-1] == ("finish",)
    assert (tmp_path / "outputs" / "id7" / "tables" / "final.tsv").exists()
