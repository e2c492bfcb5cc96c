"""The reference's scheduler experiments and the JAX package's UniPC and
Token Merging experiments through the port's CLI on the CPU (tiny models,
one sweep point, batch 2, CLIP score only): each config's table row
carries the JAX method's grid label and its plan's nfe; and the new
registry entries' argument specs against the JAX package's."""

import csv
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import registry as R
from sonicdiffusionbayeslab_torch.models import pipelines
from sonicdiffusionbayeslab_tpu import registry as JR
from sonicdiffusionbayeslab_tpu.config import load_config as jax_load_config

REPO = Path(__file__).resolve().parents[1]
PROMPTS = str(REPO / "data" / "dataset" / "prompts_sample.json")
COMMON = {
    "model.tiny": True, "model.image_size": 64, "model.dtype": "float32",
    "dataset.image_size": 64, "dataset.prompts": PROMPTS, "dataset.max_count": 2,
    "inference.batch_size": 2, "inference.batch_count": 1,
    "quality_metrics": {"clip_score": {"model_name_or_path": "openai/clip-vit-base-patch16"}},
}
# One sweep point of each shipped config, at tiny step counts
# ("<config>:<variant>" runs a config with other sweep values).
POINTS = {
    "default_stable_diffusion": {"experiment_params.num_inference_steps": [3]},
    "ddim_config": {"experiment_params.num_inference_steps": [3]},
    "deep_cache_config": {"experiment_params.cache_interval": [2],
                          "experiment_params.num_inference_steps": [4]},
    "consistency_model_config": {"experiment_params.num_inference_steps": [2]},
    "two_schedulers_config": {"experiment_params.num_inference_steps_first": [4],
                              "experiment_params.num_inference_steps_second": [4],
                              "experiment_params.num_step_switch": [2]},
    "interliving_schedulers_config": {"experiment_params.num_inference_steps": [6],
                                      "experiment_params.interliving_steps": [[1]]},
    "skip_steps_config": {"experiment_params.num_inference_steps": [5],
                          "experiment_params.skip_steps": [[2]]},
    "unipc_config": {"experiment_params.num_inference_steps": [4]},
    "tome_config": {"experiment_params.tome_ratio": [0.5],
                    "experiment_params.num_inference_steps": [3]},
    "deep_cache_config:tome": {"experiment_params.cache_interval": [2],
                               "experiment_params.num_inference_steps": [4],
                               "experiment_params.tome_ratio": 0.5},
}
# Call arguments that are not plan arguments.
NOT_PLAN_KW = ("use_x0", "guidance_scale")


def _jax_points(config_path, overrides):
    """(label, nfe) of each grid point of the JAX method, from its
    ``setup_scheduler`` and ``grid`` on a stub that carries the config,
    ``params`` and a model namespace, and the JAX pipeline's
    ``build_plan`` on that namespace: no JAX model is built."""
    JR.load_all_plugins()
    cfg = jax_load_config(config_path, overrides)
    method_cls = JR.methods_registry[cfg.experiment.method]
    stub = object.__new__(method_cls)
    stub.config, stub.model = cfg, types.SimpleNamespace(scheduler=None)
    stub.params = cfg.get("experiment_params", {})
    method_cls.setup_scheduler(stub)
    pipe_cls = JR.models_registry[cfg.model.model_name]
    out = []
    for point in method_cls.grid(stub):
        kw = {k: v for k, v in point["call_kw"].items() if k not in NOT_PLAN_KW}
        out.append((point["label"], pipe_cls.build_plan(stub.model, **kw).nfe))
    return out


def _random_kohya_lora(path):
    """A random kohya-layout LoRA on two attention projections of the tiny
    UNet."""
    rng = np.random.default_rng(0)
    sd = {}
    for name, (o, i) in {"down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": (32, 32),
                         "mid_block_attentions_0_transformer_blocks_0_attn2_to_v": (64, 32)}.items():
        sd[f"lora_unet_{name}.lora_down.weight"] = torch.as_tensor(
            rng.standard_normal((4, i)), dtype=torch.float32)
        sd[f"lora_unet_{name}.lora_up.weight"] = torch.as_tensor(
            rng.standard_normal((o, 4)), dtype=torch.float32)
        sd[f"lora_unet_{name}.alpha"] = torch.tensor(4.0)
    torch.save(sd, path)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_method_config_runs_through_the_cli(name, tmp_path, monkeypatch, capsys):
    config = str(REPO / "configs" / f"{name.split(':')[0]}.yaml")
    overrides = {**COMMON, **POINTS[name], "logger.run_id": "run"}
    merged = []
    if name == "consistency_model_config":
        _random_kohya_lora(tmp_path / "lora.bin")
        overrides["model.lora"] = str(tmp_path / "lora.bin")
        fuse = pipelines.StableDiffusionModel.fuse_lora

        def recording_fuse(self, scale=1.0):
            out = fuse(self, scale)
            merged.extend(self.lora_merged)
            return out

        monkeypatch.setattr(pipelines.StableDiffusionModel, "fuse_lora", recording_fuse)
    want = _jax_points(config, overrides)
    monkeypatch.chdir(tmp_path)
    metrics = cli.run(config, overrides, device="cpu")
    assert "run dir: outputs/run" in capsys.readouterr().out
    with open(tmp_path / "outputs" / "run" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert [(r["exp"], int(r["nfe"])) for r in rows] == want and len(want) == 1
    assert metrics["exp"] == [want[0][0]]
    assert float(rows[0]["time"]) > 0 and 0.0 <= float(rows[0]["clip_score"]) <= 100.0
    pngs = list((tmp_path / "outputs").glob(f"*/{want[0][0]}/*.png"))
    assert len(pngs) == 2
    if name == "consistency_model_config":
        assert merged == ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                          "mid_block.attentions.0.transformer_blocks.0.attn2.to_v"]


@pytest.mark.parametrize("reg,name", [
    ("models_registry", "stable_diffusion_model_two_schedulers"),
    ("models_registry", "stable_diffusion_model_interliving_schedulers"),
    ("models_registry", "stable_diffusion_model_skip_timesteps"),
    ("methods_registry", "default"), ("methods_registry", "ddim"),
    ("methods_registry", "deep_cache"), ("methods_registry", "consistency_model"),
    ("methods_registry", "two_schedulers"), ("methods_registry", "interliving_schedulers"),
    ("methods_registry", "skip_steps"), ("methods_registry", "unipc"),
    ("methods_registry", "deis"), ("methods_registry", "tome"),
    ("schedulers_registry", "ddim_scheduler"), ("schedulers_registry", "lcm_scheduler"),
    ("schedulers_registry", "pndm_scheduler"), ("schedulers_registry", "deis_scheduler"),
    ("schedulers_registry", "unipc_scheduler"), ("schedulers_registry", "euler_scheduler"),
    ("schedulers_registry", "euler_ancestral_scheduler"),
    ("schedulers_registry", "heun_scheduler"),
])
def test_new_entries_arg_specs_match_jax(reg, name):
    """The same arguments and defaults (a pipeline keeps the JAX arguments
    it has features for, and adds ``device``)."""
    R.load_all_plugins()
    JR.load_all_plugins()
    port, want = getattr(R, reg).arg_specs(name), getattr(JR, reg).arg_specs(name)
    spec = {k: (s.required, None if s.required else repr(s.default)) for k, s in port.items()
            if k != "device" or reg != "models_registry"}
    jspec = {k: (s.required, None if s.required else repr(s.default)) for k, s in want.items()}
    if reg == "models_registry":
        jspec = {k: v for k, v in jspec.items() if k in spec}
    assert spec == jspec


def test_pipeline_takes_the_lora_argument_as_jax_does():
    R.load_all_plugins()
    JR.load_all_plugins()
    spec = R.models_registry.arg_specs("stable_diffusion_model")["lora"]
    want = JR.models_registry.arg_specs("stable_diffusion_model")["lora"]
    assert (spec.required, spec.default, spec.annotation) == (
        want.required, want.default, want.annotation)
